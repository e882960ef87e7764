"""(w,k)-minimizer sketch as a batched device kernel.

Re-derivation of the reference sketch (minimap2-coverage/sketch.c:76-142)
as pure per-position rules over the buffer-entry sequence, instead of the
C rolling ring buffer. Validated exhaustively against a faithful
emulation (tests/oracles/sketch_ref.py) including N-resets, hash ties,
symmetric k-mers and short reads:

Let S be the sequence of buffer entries (all positions except symmetric
k-mers), x[s] the packed key hash<<8|span (+inf when ineligible), l[s]
the non-symmetric valid run counter, and wmin[s] the *rightmost* minimal
entry of the w-window ending at s. A position p is emitted once per:

  A) reign push: p is emitted iff p == wmin_idx[s] for some s (its
     "reign" as the tracked minimum), with e = last such s, and
       - e == n-1                                  (final push), or
       - x[e+1] <= x[p]  and l[e+1] >= w+k         (replace push), or
       - x[e+1] >  x[p]  and l[e+1] >= w+k-1       (displacement push)
  B) first-window tie: some t0 in [p+1, p+w-1] has l[t0] == w+k-1,
     x[p] == wmin_x[t0-1], and wmin_idx[t0-1] != p
  C) rescan tie: some s in [p+1, p+w-1] is a displacement step
     (wmin_idx[s-1] == s-w and x[s] > wmin_x[s-1]) with l[s] >= w+k-1,
     x[p] == wmin_x[s], and wmin_idx[s] != p

Multiplicity is preserved (B and C may each fire for several windows).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def hash64(key, mask):
    """Invertible minimizer hash (cf. sketch.c:27-37).

    Dtype-generic: for 2k <= 30 the masked arithmetic wraps identically
    in uint32 lanes (every step re-masks, and mod-2^32 wrapping
    preserves the masked value), so the main presets (k = 12, 15) avoid
    u64 entirely."""
    dt = key.dtype.type
    key = (~key + (key << dt(21))) & mask
    key = key ^ (key >> dt(24))
    key = ((key + (key << dt(3))) + (key << dt(8))) & mask
    key = key ^ (key >> dt(14))
    key = ((key + (key << dt(2))) + (key << dt(4))) & mask
    key = key ^ (key >> dt(28))
    key = (key + (key << dt(31))) & mask
    return key


def _shift_left(a, d, fill):
    """a'[..., i] = a[..., i+d], filling the right edge: a pure
    pad+slice. Replaces clipped-index take_along_axis gathers for
    constant-offset lookups: rules B/C only ever look ahead by a
    static offset (every out-of-range lane is masked by the caller)."""
    if d == 0:
        return a
    return jnp.pad(a, ((0, 0), (0, d)), constant_values=fill)[:, d:]


def _sliding_rightmost_min(x, w):
    """For each s: (value, index) of the rightmost minimum over the
    window [s-w+1, s] (out-of-range treated as +inf).

    x: (..., L) unsigned ints. Returns (vals, idxs) of same shape.
    Uses shift-and-combine doubling: O(log w) vector steps.
    """
    L = x.shape[-1]
    UMAX = jnp.array(jnp.iinfo(x.dtype).max, x.dtype)
    idx = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), x.shape)
    vals, idxs = x, idx
    # combine semantics: prefer smaller value; on tie prefer larger index.
    span = 1
    while span < w:
        step = min(span, w - span)
        sv = jnp.roll(vals, step, axis=-1)
        si = jnp.roll(idxs, step, axis=-1)
        pos = jnp.arange(L, dtype=jnp.int32)
        ok = (pos >= step)
        sv = jnp.where(ok, sv, UMAX)
        si = jnp.where(ok, si, -1)
        # current (vals) is the right/tie-preferred side
        take_shift = sv < vals
        vals = jnp.where(take_shift, sv, vals)
        idxs = jnp.where(take_shift, si, idxs)
        span += step
    return vals, idxs


def _sketch_core(codes, lengths, *, w, k, positions=None, spans=None,
                 seg=None):
    """Batched minimizer sketch over padded (B, L) code tiles.

    positions/spans: optional (B, L) overrides for homopolymer-compressed
    input (codes then hold one entry per HPC run; positions = run end
    index in the original read, spans = windowed sum of the last <=k run
    lengths, cf. sketch.c:92-104). Default: positions = arange,
    span = k (plain mode).

    seg: optional (B, L) int32 read-segment ids for multi-read packed
    rows (non-decreasing along each row). Each segment must open with
    >= w-1 ambiguous separator bases owned by THAT segment (so no
    sliding window ending at one segment's entry can reach an earlier
    segment's entries), and the emission rules are gated so every
    segment sketches exactly as if it were a standalone read: rule-A
    reigns only count windows ending in the same segment, the final
    push fires at each segment's last entry, and rules B/C only look
    ahead within the segment. Differentially tested per read against
    the single-read path (tests/test_device_index.py,
    test_packed_tiles_match_per_read).

    Returns dict with (B, L) arrays aligned to buffer-entry positions:
      emit:   per-entry emission count (0 => not a minimizer)
      hash:   uint64 packed key  hash64(kmer)<<8 | span
      pos:    int32 read position of the k-mer's last base
      strand: int32 0/1
      n_entries: (B,) number of buffer entries (S length) per read
    Callers compact by emit>0 (replicating count>1, which is rare).
    """
    assert 0 < w < 256 and 0 < k <= 28
    B, L = codes.shape
    # u32 fast path: for 2k <= 30 (all main presets) hash values stay
    # below the u32 sentinel and every masked step wraps identically,
    # so no u64 touches the device. HPC (varying spans) keeps the packed-u64
    # path; it only ever runs on the 5000-read sample.
    use_u32 = (2 * k <= 30) and (spans is None)
    U = jnp.uint32 if use_u32 else jnp.uint64
    UMAX = (jnp.uint32(0xFFFFFFFF) if use_u32 else UINT64_MAX)
    mask = U((1 << (2 * k)) - 1)
    c = codes.astype(U)
    valid = codes < 4
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_read = pos < lengths[:, None]
    valid = valid & in_read

    # --- k-mers roll over the valid-base subsequence (C registers skip
    # ambiguous bases and are never cleared): compact valid bases.
    # Compactions use one argsort (stable, keys place valid positions
    # first in order) + gathers.
    vcount = jnp.cumsum(valid, axis=1)          # 1-based rank among valid
    n_valid = vcount[:, -1]
    pos_of_vrank = jnp.argsort(
        jnp.where(valid, pos, L + pos).astype(jnp.int32), axis=1)
    cval = jnp.where(valid, c, 0)
    cv = jnp.take_along_axis(cval, pos_of_vrank, axis=1)

    # forward/reverse k-mer registers at each valid-space position
    ud = U
    kf = jnp.zeros((B, L), ud)
    kr = jnp.zeros((B, L), ud)
    dt = np.uint32 if use_u32 else np.uint64
    shift1 = dt(2 * (k - 1))
    vpos = jnp.arange(L, dtype=jnp.int32)[None, :]
    for j in range(k):
        # base entering j steps before current: the newest base (age 0)
        # sits in the low bits (C: kmer[0] = kmer[0]<<2 | c)
        sh = jnp.pad(cv, ((0, 0), (j, 0)))[:, :L]
        present = vpos >= j  # before the first k bases the register is 0
        kf = kf | jnp.where(present, sh << dt(2 * j), 0)
        kr = kr | jnp.where(present,
                            ((dt(3) ^ sh) & dt(3))
                            << (shift1 - dt(2 * j)), 0)
    kf = kf & mask
    kr = kr & mask
    vspace = jnp.arange(L, dtype=jnp.int32)[None, :] < n_valid[:, None]
    sym = (kf == kr) & vspace
    strand_v = jnp.where(kf < kr, 0, 1).astype(jnp.int32)
    kmin = jnp.where(kf < kr, kf, kr)

    hash_v = hash64(kmin, mask)  # span packed later, in read space

    # --- map back to read space (the inverse of the compaction is a
    # gather through each position's valid-rank): arr_r[i] =
    # arr_v[vcount[i]-1] where valid.
    rpos = jnp.broadcast_to(pos, (B, L))
    vr = jnp.clip(vcount - 1, 0, L - 1)
    sym_r = jnp.take_along_axis(sym, vr, axis=1) & valid
    hash_r = jnp.where(valid,
                       jnp.take_along_axis(hash_v, vr, axis=1),
                       UMAX)
    strand_r = jnp.where(valid,
                         jnp.take_along_axis(strand_v, vr, axis=1), 0)

    is_S = in_read & ~sym_r
    # l counter: +1 at valid non-symmetric, reset to 0 at ambiguous.
    # compute in read space: reset points are ambiguous positions.
    inc = (valid & ~sym_r).astype(jnp.int32)
    ambig = in_read & ~valid
    # l[i] = number of inc since last ambig (inclusive scan)
    cum_inc = jnp.cumsum(inc, axis=1)
    # last ambiguous position index at or before i (segmented reset)
    amb_cum = jnp.where(ambig, cum_inc, 0)
    run_base = jax.lax.associative_scan(jnp.maximum, amb_cum, axis=1)
    l_r = cum_inc - run_base

    # --- compact S-space arrays (argsort + gathers, as above)
    s_rank = jnp.cumsum(is_S, axis=1)
    n_S = s_rank[:, -1]
    pos_of_srank = jnp.argsort(
        jnp.where(is_S, pos, L + pos).astype(jnp.int32), axis=1)

    def compact(arr, fill):
        return jnp.take_along_axis(arr, pos_of_srank, axis=1)

    if positions is not None:
        rpos = positions.astype(jnp.int32)
    if spans is None:
        # constant span (== k): ordering by bare hash equals ordering
        # by the packed key, so no packing is needed. This covers both
        # the u32 fast path (2k <= 30) and the plain wide-hash path
        # (k up to 28, e.g. the pb-hifi fast preset's k = 19), whose
        # bare u64 hashes downstream consumers carry as int64 lanes.
        eligible = valid & (l_r >= k)
        packed_r = hash_r
    else:
        span_r = spans.astype(jnp.int32)
        eligible = valid & (l_r >= k) & (span_r < 256) & (span_r > 0)
        packed_r = ((hash_r << jnp.uint64(8))
                    | span_r.astype(jnp.uint64) & jnp.uint64(0xFF))
    xs = compact(jnp.where(eligible, packed_r, UMAX), UMAX)
    ys_pos = compact(jnp.where(valid, rpos, 0), 0)
    ys_strand = compact(strand_r, 0)
    ls = compact(l_r, 0)
    sspace = jnp.arange(L, dtype=jnp.int32)[None, :] < n_S[:, None]
    xs = jnp.where(sspace, xs, UMAX)
    seg_s = None
    if seg is not None:
        # entry-space segment ids; padding gets a sentinel so it never
        # matches a real segment
        seg_s = jnp.where(sspace, compact(seg.astype(jnp.int32), 0),
                          jnp.int32(1 << 30))

    # --- rightmost sliding minima
    wx, widx = _sliding_rightmost_min(xs, w)

    # --- rule A: reigns and pushes. reign_end[p] = last s with
    # wmin_idx[s] == p; s - p < w, so w shifted compares replace a
    # scatter-max.
    sarange = jnp.arange(L, dtype=jnp.int32)[None, :]
    valid_tracked = (wx != UMAX) & sspace
    widx_eff = jnp.where(valid_tracked, widx, -1)
    reign_end = jnp.full((B, L), -1, jnp.int32)
    for d in range(w):
        # widx at position p + d (shift left by d, pad with -1)
        shifted = jnp.pad(widx_eff, ((0, 0), (0, d)),
                          constant_values=-1)[:, d:]
        hit = shifted == sarange
        if seg_s is not None:
            # only windows ending in p's own segment count as reigns
            seg_sh = jnp.pad(seg_s, ((0, 0), (0, d)),
                             constant_values=-1)[:, d:]
            hit = hit & (seg_sh == seg_s)
        reign_end = jnp.maximum(reign_end,
                                jnp.where(hit, sarange + d, -1))

    has_reign = reign_end >= 0
    e = reign_end
    n_s = n_S[:, None]
    e_next = jnp.clip(e + 1, 0, L - 1)
    x_next = jnp.take_along_axis(xs, e_next, axis=1)
    l_next = jnp.take_along_axis(ls, e_next, axis=1)
    at_end = e == n_s - 1
    if seg_s is not None:
        # a segment's last entry plays the standalone read's final entry
        seg_next = jnp.take_along_axis(seg_s, e_next, axis=1)
        at_end = at_end | (seg_next != seg_s)
    final_push = has_reign & at_end
    replace_push = has_reign & ~at_end & (x_next <= xs) & (l_next >= w + k)
    disp_push = has_reign & ~at_end & (x_next > xs) & (l_next >= w + k - 1)
    emitA = (final_push | replace_push | disp_push) & (xs != UMAX)

    # --- rules B and C per offset d in [1, w-1]
    countB = jnp.zeros((B, L), jnp.int32)
    countC = jnp.zeros((B, L), jnp.int32)
    # displacement step flags per s
    pad_max = (np.uint32(0xFFFFFFFF) if use_u32
               else np.uint64(0xFFFFFFFFFFFFFFFF))
    wx_prev = jnp.pad(wx, ((0, 0), (1, 0)),
                      constant_values=pad_max)[:, :L]
    widx_prev = jnp.pad(widx, ((0, 0), (1, 0)), constant_values=-1)[:, :L]
    disp_step = ((widx_prev == sarange - w) & (xs > wx_prev)
                 & (wx_prev != UMAX) & sspace & (sarange >= 1))
    is_t0 = (ls == w + k - 1) & sspace

    for d in range(1, w):
        # B: t0 = p + d. All look-aheads are constant shifts (pad+slice
        # via _shift_left, not gathers); every lane whose shifted read
        # ran off the row is masked by valid_off below.
        valid_off = (sarange + d) < n_s
        if seg_s is not None:
            # look-ahead stays within p's segment (standalone machines
            # have no windows past their own last entry)
            valid_off = valid_off & \
                (_shift_left(seg_s, d, 1 << 30) == seg_s)
        b_hit = (_shift_left(is_t0, d, False)
                 & (xs == _shift_left(wx, d - 1, pad_max))
                 & (_shift_left(widx, d - 1, -1) != sarange)
                 & (xs != UMAX) & valid_off)
        countB = countB + b_hit.astype(jnp.int32)
        # C: s = p + d
        c_hit = (_shift_left(disp_step, d, False)
                 & (_shift_left(ls, d, 0) >= w + k - 1)
                 & (xs == _shift_left(wx, d, pad_max))
                 & (_shift_left(widx, d, -1) != sarange)
                 & (xs != UMAX) & valid_off)
        countC = countC + c_hit.astype(jnp.int32)

    emit = emitA.astype(jnp.int32) + countB + countC
    out = {
        "emit": emit,
        "hash": xs,
        "pos": ys_pos,
        "strand": ys_strand,
        "n_entries": n_S,
    }
    if seg_s is not None:
        out["seg"] = seg_s
    return out


def sketch_to_lists(res, k=None, packed=None):
    """Host-side compaction of sketch_batch output into per-read
    (hash, pos, strand, span) numpy arrays in position order with
    multiplicity. Plain-mode output stores bare hashes (span == k,
    required as an argument) — u32 for 2k <= 30, u64 for wide k; the
    HPC path stores packed u64 hash<<8|span. `packed` disambiguates
    the wide-plain case (bare u64); default infers from dtype, which
    is only correct for 2k <= 30 and HPC callers."""
    emit = np.asarray(res["emit"])
    hsh = np.asarray(res["hash"])
    pos = np.asarray(res["pos"])
    strand = np.asarray(res["strand"])
    if packed is None:
        packed = hsh.dtype == np.uint64
    if not packed:
        assert k is not None, "bare-hash sketch output needs k for spans"
    out = []
    for b in range(emit.shape[0]):
        idx = np.nonzero(emit[b] > 0)[0]
        rep = np.repeat(idx, emit[b][idx])
        hh = hsh[b][rep]
        if packed:
            out.append((hh >> np.uint64(8),
                        pos[b][rep].astype(np.int64),
                        strand[b][rep].astype(np.int64),
                        (hh & np.uint64(0xFF)).astype(np.int64)))
        else:
            out.append((hh.astype(np.uint64),
                        pos[b][rep].astype(np.int64),
                        strand[b][rep].astype(np.int64),
                        np.full(len(hh), k, np.int64)))
    return out


sketch_batch = functools.partial(jax.jit, static_argnames=("w", "k"))(
    _sketch_core)


@functools.partial(jax.jit, static_argnames=("w", "k", "m_max"))
def sketch_batch_compact(codes, lengths, *, w, k, m_max,
                         positions=None, spans=None):
    """Minimizer sketch with on-device output compaction.

    Emitted entries are packed densely so only ~n_minimizer slots cross
    the host-device boundary instead of full (B, L) tiles:
      keys: (B, m_max) uint64  packed x (hash<<8|span)
      meta: (B, m_max) int32   pos<<5 | strand<<4 | min(count, 15)
      n_slots: (B,) int32      compacted entries per read
      overflow: (B,) bool      n_slots exceeded m_max (host fallback)
    """
    res = _sketch_core(codes, lengths, w=w, k=k, positions=positions,
                       spans=spans)
    B, L = codes.shape
    emit = res["emit"]
    has = emit > 0
    rank = jnp.cumsum(has, axis=1)
    n_slots = rank[:, -1]
    posl = jnp.arange(L, dtype=jnp.int32)[None, :]
    order = jnp.argsort(jnp.where(has, posl, L + posl).astype(jnp.int32),
                        axis=1)[:, :m_max]
    keys = jnp.take_along_axis(res["hash"], order, axis=1)
    # count field: emissions per entry can reach ~w; 4 bits suffices
    # for all supported presets (w <= 10)
    meta_src = ((res["pos"] << 5) | (res["strand"] << 4)
                | jnp.minimum(emit, 15))
    meta = jnp.take_along_axis(meta_src, order, axis=1)
    valid_slot = jnp.arange(m_max, dtype=jnp.int32)[None, :] \
        < jnp.minimum(n_slots, m_max)[:, None]
    keys = jnp.where(valid_slot, keys,
                     np.array(np.iinfo(keys.dtype).max, keys.dtype))
    meta = jnp.where(valid_slot, meta, 0)
    return {
        "keys": keys,
        "meta": meta,
        "n_slots": jnp.minimum(n_slots, m_max),
        "overflow": n_slots > m_max,
    }


def compact_to_lists(res, k=None, packed=None):
    """Host expansion of sketch_batch_compact output into per-read
    (hash, pos, strand, span) arrays (sketch_to_lists contract;
    `packed` as there)."""
    keys = np.asarray(res["keys"])
    meta = np.asarray(res["meta"])
    n_slots = np.asarray(res["n_slots"])
    if packed is None:
        packed = keys.dtype == np.uint64
    if not packed:
        assert k is not None, "bare-hash sketch output needs k for spans"
    out = []
    for b in range(keys.shape[0]):
        n = int(n_slots[b])
        kk = keys[b, :n]
        mm = meta[b, :n]
        cnt = mm & 15
        if (cnt > 1).any():
            rep = np.repeat(np.arange(n), cnt)
            kk = kk[rep]
            mm = mm[rep]
        if packed:
            out.append((kk >> np.uint64(8),
                        (mm >> 5).astype(np.int64),
                        ((mm >> 4) & 1).astype(np.int64),
                        (kk & np.uint64(0xFF)).astype(np.int64)))
        else:
            out.append((kk.astype(np.uint64),
                        (mm >> 5).astype(np.int64),
                        ((mm >> 4) & 1).astype(np.int64),
                        np.full(len(kk), k, np.int64)))
    return out
