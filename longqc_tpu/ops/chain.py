"""Anchor chaining DP as a batched device kernel.

Reproduces mm_chain_dp's score fill (chain.c:41-80) including the
max_skip pruning heuristic, reformulated for a vector machine:

- The sequential predecessor loop becomes a lax.scan over anchors with
  an age-ordered ring buffer of the last J anchors, vmapped over a
  batch of query rows.
- The C gap penalty `(int)(dd * .01 * avg_qspan) + (ilog2(dd)>>1)`
  is exactly double-rounded via a per-query host-precomputed table
  indexed by dd (dd <= bw, so the table is tiny), with no f64 on the
  device.
- max_skip pruning: the C breaks the descent after >max_skip "skip
  events" (non-improving visits of marked anchors, where marks t[p[j]]
  are set by already-visited anchors). Skip counting is a 0-clamped
  walk computed with prefix sums; the mark set depends on the break
  point itself, so two bounding passes run (marks from all window
  entries, then marks from entries before the first-pass break); rows
  where the passes disagree — or where the ring is shorter than the
  admissible distance window — are flagged for exact host recompute.
  Marks are maintained as per-query bitmasks (two 32-bit words for
  J = 64), avoiding scatters and large compare matrices.
- The kernel is *chunk-resumable*: the ring-buffer carry is an explicit
  input/output, so arbitrarily long anchor rows stream through a single
  compiled (Q, A) shape — compilation happens once per process.

Outputs per anchor: f (best chain score ending here), p (predecessor
index or -1), v (peak score), matching the C arrays; chain extraction/
backtracking runs on host (tiny pointer-chasing, numpy).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.int32(-(10 ** 9))


def gap_penalty_table(avg_qspan, bw):
    """Host: per-query penalty[dd] for dd in [0, bw], f64-exact
    (chain.c:67)."""
    dd = np.arange(bw + 1, dtype=np.float64)
    lin = (dd * 0.01 * np.float64(np.float32(avg_qspan))).astype(np.int64)
    log_dd = np.zeros(bw + 1, dtype=np.int64)
    nz = np.arange(1, bw + 1)
    log_dd[1:] = np.floor(np.log2(nz)).astype(np.int64)
    return (lin + (log_dd >> 1)).astype(np.int32)


def make_carry(Q, J=64):
    """Fresh ring-buffer carry for a batch of Q rows (host arrays)."""
    zJ = np.zeros((Q, J), np.int32)
    return (zJ - 1, zJ.copy(), zJ.copy(), zJ.copy(), zJ.copy(),
            zJ.copy(), zJ - (10 ** 9), np.zeros((Q,), bool))


@functools.partial(jax.jit, static_argnames=("J", "max_dist", "bw",
                                             "max_skip"))
def chain_dp_batch(ax_hi, ax_lo, aq, aspan, n_anchors, pen_tab, carry,
                   i0, *, J=64, max_dist=10000, bw=500, max_skip=25):
    """Batched, resumable chain-DP fill.

    ax_hi:  (Q, A) int32 anchor x upper bits (rev<<31 | rid), row-sorted
    ax_lo:  (Q, A) int32 anchor target position (x low 32 bits)
    aq:     (Q, A) int32 query positions
    aspan:  (Q, A) int32 spans
    n_anchors: (Q,) int32 — TOTAL anchors per row (absolute count)
    pen_tab: (Q, bw+1) int32 gap penalties per dd
    carry:  ring state from make_carry() / a previous chunk
    i0:     absolute index of this chunk's first anchor (int32 scalar)

    The 64-bit anchor key is split so the scan body runs entirely in
    int32 lanes.

    Returns (f, p, v): (Q, A) int32 (p = absolute predecessor index,
    -1 none), flags: (Q,) bool, and the carry for the next chunk.
    """
    assert J == 64, "bitmask mark tracking is specialized to J=64"
    Q, A = ax_hi.shape
    ages = jnp.arange(1, J + 1, dtype=jnp.int32)  # age-ordered ring

    def one_anchor(carry, i):
        (rxh, rxl, rq, rs, rf, rv, rp, flag) = carry
        xh_i = jax.lax.dynamic_index_in_dim(ax_hi, i - i0, 1, False)
        xl_i = jax.lax.dynamic_index_in_dim(ax_lo, i - i0, 1, False)
        q_i = jax.lax.dynamic_index_in_dim(aq, i - i0, 1, False)
        s_i = jax.lax.dynamic_index_in_dim(aspan, i - i0, 1, False)
        row_on = i < n_anchors  # (Q,)

        exists = (i - ages)[None, :] >= 0  # (1, J)
        dr = xl_i[:, None] - rxl
        dr_ok = (xh_i[:, None] == rxh) & (dr >= 0) & (dr <= max_dist)
        dq = q_i[:, None] - rq
        valid = (exists & dr_ok & (dr != 0) & (dq > 0) & (dq <= max_dist))
        dd = jnp.abs(dr - dq)
        valid = valid & (dd <= bw)

        sc0 = jnp.minimum(jnp.minimum(dq, dr), s_i[:, None])
        pen = jnp.take_along_axis(pen_tab, jnp.clip(dd, 0, bw), axis=1)
        sc = jnp.where(valid, sc0 - pen + rf, NEG)

        # strict running max in visit (age) order, exclusive prefix
        inc = jax.lax.associative_scan(jnp.maximum, sc, axis=1)
        run_before = jnp.concatenate(
            [jnp.broadcast_to(s_i[:, None], (Q, 1)),
             jnp.maximum(inc[:, :-1], s_i[:, None])], axis=1)
        newmax = valid & (sc > run_before)

        # marks as 2x32-bit words per query: bit (tgt_age-1) set when a
        # window entry's stored predecessor points at that age
        tgt_age = i - rp  # (Q, J)

        def marks_from(src_mask):
            ok = (src_mask & (rp > NEG + J + 1)
                  & (tgt_age >= 1) & (tgt_age <= J))
            t0 = jnp.clip(tgt_age - 1, 0, 63)
            lo_bit = jnp.where(ok & (t0 < 32),
                               jnp.left_shift(jnp.int32(1),
                                              jnp.clip(t0, 0, 31)), 0)
            hi_bit = jnp.where(ok & (t0 >= 32),
                               jnp.left_shift(jnp.int32(1),
                                              jnp.clip(t0 - 32, 0, 31)), 0)
            for _ in range(6):  # OR-reduce over J = 64 sources
                h = lo_bit.shape[1] // 2
                lo_bit = lo_bit[:, :h] | lo_bit[:, h:]
                hi_bit = hi_bit[:, :h] | hi_bit[:, h:]
            lo_w = lo_bit[:, 0]
            hi_w = hi_bit[:, 0]
            sel = jnp.where(
                ages[None, :] <= 32,
                jnp.right_shift(lo_w[:, None],
                                jnp.clip(ages[None, :] - 1, 0, 31)),
                jnp.right_shift(hi_w[:, None],
                                jnp.clip(ages[None, :] - 33, 0, 31)))
            return (sel & 1) == 1

        def walk_cut(marks):
            skipev = valid & ~newmax & marks
            delta = jnp.where(skipev, 1, jnp.where(newmax, -1, 0))
            S = jnp.cumsum(delta, axis=1)
            minS = jax.lax.associative_scan(jnp.minimum, S, axis=1)
            walk = S - jnp.minimum(0, minS)
            brk = skipev & (walk > max_skip)
            return jnp.min(jnp.where(brk, ages[None, :], J + 1), axis=1)

        marks0 = marks_from(valid)
        cut0 = walk_cut(marks0)
        marks1 = marks_from(valid & (ages[None, :] < cut0[:, None]))
        cut1 = walk_cut(marks1)
        disagree = cut0 != cut1

        cut = cut1
        in_cut = ages[None, :] <= cut[:, None]
        nm_in = newmax & in_cut
        p_age = jnp.max(jnp.where(nm_in, ages[None, :], 0), axis=1)
        has_pred = p_age > 0
        f_i = jnp.where(has_pred,
                        jnp.max(jnp.where(nm_in, sc, NEG), axis=1), s_i)
        p_abs = jnp.where(has_pred, i - p_age, NEG)
        v_pred = jnp.max(jnp.where(ages[None, :] == p_age[:, None],
                                   rv, NEG), axis=1)
        v_i = jnp.where(has_pred & (v_pred > f_i), v_pred, f_i)

        # truncation: no break and the oldest ring entry still admissible
        oldest_ok = exists[:, J - 1] & dr_ok[:, J - 1]
        trunc = (cut > J) & oldest_ok
        flag = flag | (row_on & (disagree | trunc))

        def push(ring, val):
            return jnp.concatenate([val[:, None], ring[:, :-1]], axis=1)
        carry = (push(rxh, xh_i), push(rxl, xl_i), push(rq, q_i),
                 push(rs, s_i), push(rf, f_i), push(rv, v_i),
                 push(rp, p_abs), flag)
        out = (jnp.where(row_on, f_i, 0),
               jnp.where(row_on, p_abs, -1),
               jnp.where(row_on, v_i, 0))
        return carry, out

    carry = tuple(jnp.asarray(c) for c in carry)
    carry, (f, p, v) = jax.lax.scan(
        one_anchor, carry, i0 + jnp.arange(A, dtype=jnp.int32))
    p = jnp.where(p < -1, -1, p)
    return f.T, p.T, v.T, carry[-1], carry


def backtrack_chains(f, p, v, n, min_cnt, min_sc):
    """Host chain extraction (chain.c:82-124 semantics): find chain
    ends, sort by (score, end) desc, greedy backtrack with anchor
    ownership; rejected chains keep their marks. Returns
    [(score, anchor_idx_array)]."""
    f = np.asarray(f[:n], np.int64)
    p = np.asarray(p[:n], np.int64)
    v = np.asarray(v[:n], np.int64)
    t = np.zeros(n, bool)
    t[p[p >= 0]] = True
    ends = np.nonzero(~t & (v >= min_sc))[0]
    if len(ends) == 0:
        return []
    u = []
    for i in ends:
        j = i
        while j >= 0 and f[j] < v[j]:
            j = p[j]
        if j < 0:
            j = i
        u.append((int(f[j]), int(j)))
    u.sort(key=lambda s: (s[0], s[1]), reverse=True)
    used = np.zeros(n, bool)
    chains = []
    for score, end in u:
        path = []
        j = end
        while j >= 0 and not used[j]:
            path.append(j)
            used[j] = True
            j = p[j]
        if j < 0:
            if len(path) >= min_cnt:
                chains.append((score, np.array(path[::-1], np.int64)))
        elif score - int(f[j]) >= min_sc:
            if len(path) >= min_cnt:
                chains.append((score - int(f[j]),
                               np.array(path[::-1], np.int64)))
    return chains
