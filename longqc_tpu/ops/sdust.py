"""Symmetric DUST low-complexity masking (cf. sdust.c, Morgulis 2006).

Two-tier design:
  1. A vectorized device *screen* computes, per position, the windowed
     triplet counts and flags any position where the masking recursion
     could possibly trigger:  rw*10 > len*T  (with len >= the shrunk L
     the C uses) or any triplet count >= 2T/10+1 (the cv-shrink
     condition, sdust.c:85).  Reads with no flagged positions provably
     have masked_len == 0 — the overwhelmingly common case.
  2. Flagged reads run the exact sequential recursion on host.

The sdust table row is `name, masked_len, len, frac, meanQ, nQ7`
(sdust.c:211-217); that table doubles as LongQC's master per-read
length/QV table.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from longqc_tpu.io.pack import SEQ_NT4_SDUST

SD_WLEN = 3
SD_WTOT = 64


# ---------------------------------------------------------------------------
# exact host recursion (behavioral spec of sdust_core, sdust.c:72-177)


def sdust_host(seq, T=20, W=64):
    """-> list of (start, end) merged masked intervals for one read."""
    codes = SEQ_NT4_SDUST[np.frombuffer(seq.encode("ascii"),
                                        dtype=np.uint8)]
    res = []          # merged intervals
    P = []            # perfect intervals: dicts, sorted desc by start
    win = []          # triplet window (deque)
    L = 0
    rw = rv = 0
    cw = [0] * SD_WTOT
    cv = [0] * SD_WTOT

    def save_masked_regions(start):
        nonlocal P
        if not P or P[-1]["start"] >= start:
            return
        p = P[-1]
        saved = False
        if res:
            s, f = res[-1]
            if p["start"] <= f:
                saved = True
                res[-1] = (s, max(f, p["finish"]))
        if not saved:
            res.append((p["start"], p["finish"]))
        i = len(P) - 1
        while i >= 0 and P[i]["start"] < start:
            i -= 1
        del P[i + 1:]

    def shift_window(t):
        nonlocal L, rw, rv
        if len(win) >= W - SD_WLEN + 1:
            s = win.pop(0)
            cw[s] -= 1
            rw -= cw[s]
            if L > len(win):
                L -= 1
                cv[s] -= 1
                rv -= cv[s]
        win.append(t)
        L += 1
        rw += cw[t]
        cw[t] += 1
        rv += cv[t]
        cv[t] += 1
        if cv[t] * 10 > (T << 1):
            while True:
                s = win[len(win) - L]
                cv[s] -= 1
                rv -= cv[s]
                L -= 1
                if s == t:
                    break

    def find_perfect(start):
        c = list(cv)
        r = rv
        max_r = max_l = 0
        for i in range(len(win) - L - 1, -1, -1):
            t = win[i]
            r += c[t]
            c[t] += 1
            new_r = r
            new_l = len(win) - i - 1
            if new_r * 10 > T * new_l:
                j = 0
                while j < len(P) and P[j]["start"] >= i + start:
                    p = P[j]
                    if max_r == 0 or p["r"] * max_l > max_r * p["l"]:
                        max_r, max_l = p["r"], p["l"]
                    j += 1
                if max_r == 0 or new_r * max_l >= max_r * new_l:
                    max_r, max_l = new_r, new_l
                    P.insert(j, {"start": i + start,
                                 "finish": len(win) + SD_WLEN - 1 + start,
                                 "r": new_r, "l": new_l})

    l = 0
    t = 0
    n = len(codes)
    for i in range(n + 1):
        b = int(codes[i]) if i < n else 4
        if b < 4:
            l += 1
            t = ((t << 2) | b) & (SD_WTOT - 1)
            if l >= SD_WLEN:
                start = max(l - W, 0) + (i + 1 - l)
                save_masked_regions(start)
                shift_window(t)
                if rw * 10 > L * T:
                    find_perfect(start)
        else:
            start = max(l - W + 1, 0) + (i + 1 - l)
            while P:
                save_masked_regions(start)
                start += 1
            l = t = 0
    return res


def sdust_masked_length(seq, T=20, W=64):
    return sum(e - s for s, e in sdust_host(seq, T, W))


# ---------------------------------------------------------------------------
# device screen


@functools.partial(jax.jit, static_argnames=("T", "W"))
def sdust_screen_batch(codes, lengths, *, T=20, W=64):
    """Per-read flag: could sdust mask anything? (sound over-approx).

    codes: (B, L) SEQ_NT4_SDUST codes. A read is clean (False) when no
    position satisfies  rw*10 > len*T  or  max triplet count >= 2T/10+1
    over any window the C recursion would use.
    """
    B, L = codes.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_read = pos < lengths[:, None]
    valid = (codes < 4) & in_read

    # triplet value per position (ending at i), valid when last 3 valid
    # and within a run of >= 3 valid bases
    c = codes.astype(jnp.int32)
    c1 = jnp.pad(c, ((0, 0), (1, 0)))[:, :L]
    c2 = jnp.pad(c, ((0, 0), (2, 0)))[:, :L]
    v1 = jnp.pad(valid, ((0, 0), (1, 0)))[:, :L]
    v2 = jnp.pad(valid, ((0, 0), (2, 0)))[:, :L]
    tri = (c2 << 4) | (c1 << 2) | c
    tri_valid = valid & v1 & v2 & (pos >= 2)

    # The C deque of pushed triplets persists across N-boundaries
    # (sdust.c:158-161 resets only l/t), so the window is the last
    # up-to-62 *pushed* triplets regardless of ambiguity gaps: window
    # arithmetic runs in triplet-rank space.
    wcap = W - SD_WLEN + 1  # 62
    tr_rank = jnp.cumsum(tri_valid, axis=1)          # 1-based at triplets
    win_n = jnp.minimum(tr_rank, wcap)
    # read position of the triplet with a given rank (for cumsum diffs)
    rank_slot = jnp.where(tri_valid, tr_rank - 1, L)
    pos_of_rank = jnp.full((B, L + 1), 0, jnp.int32)
    pos_of_rank = jax.vmap(lambda a, i, v: a.at[i].set(v))(
        pos_of_rank, rank_slot, jnp.broadcast_to(pos, (B, L)))
    back_rank = tr_rank - win_n                      # 0 => none before
    back_pos = jax.vmap(jnp.take)(
        pos_of_rank, jnp.clip(back_rank - 1, 0, L - 1))

    # windowed per-triplet counts via cumsum differences, looped over the
    # 64 triplet values to avoid a (B, L, 64) intermediate
    rw10 = jnp.zeros((B, L), jnp.int32)
    maxc = jnp.zeros((B, L), jnp.int32)
    shrink_th = (T << 1) // 10 + 1
    for tval in range(SD_WTOT):
        ind = (tri == tval) & tri_valid
        cum = jnp.cumsum(ind, axis=1)
        base = jnp.where(back_rank > 0,
                         jax.vmap(jnp.take)(cum, back_pos), 0)
        cnt = cum - base
        rw10 = rw10 + cnt * (cnt - 1) // 2
        maxc = jnp.maximum(maxc, cnt)
    trigger = ((rw10 * 10 > win_n * T) & (win_n > 0)) | (maxc >= shrink_th)
    trigger = trigger & tri_valid
    return jnp.any(trigger, axis=1)


def masked_lengths(reads, codes=None, lengths=None, T=20, W=64):
    """Per-read sdust masked length: device screen + host exact for
    flagged reads."""
    from longqc_tpu.io.pack import pack_reads
    if codes is None:
        batch = pack_reads(reads, table=SEQ_NT4_SDUST, with_quals=False)
        codes, lengths = batch.codes, batch.lengths
    flags = np.asarray(sdust_screen_batch(jnp.asarray(codes),
                                          jnp.asarray(lengths), T=T, W=W))
    out = np.zeros(len(reads), np.int64)
    for i in np.nonzero(flags)[0]:
        out[i] = sdust_masked_length(reads[i][1], T, W)
    return out
