"""Ring-buffer chain DP fill and the two chain-extraction ring passes.

Three sequential passes over each query row's sorted anchors, batched
over Q rows:

  * fill:     mm_chain_dp's score fill (chain.c:41-80) with the last J
    anchors held in an age-ordered ring — f/p/v per anchor, the
    max_skip two-pass bounding and the resumable carry of ops/chain
    (its validated reformulation), at J = 64 and the 128/256/512
    escalation rungs.
  * peak:     peak[i] = i when f[i] == v[i], else peak[p[i]]
    (the `while f[j] < v[j]: j = p[j]` walk of chain.c:96-99).
  * min-rank: r[i] = min(own_rank[i], min over j in (i, i+J] with
    p[j] == i of r[j]) — the ownership propagation of ops/chainsel
    (the closed form of the greedy backtrack), run backwards.

The fill links an anchor only to parents inside its ring, so every
parent pointer of an unflagged row satisfies 1 <= i - p[i] <= J; that
bound is what makes peak and min-rank streaming ring passes.

Each pass has two implementations that must agree bit for bit:

  * "scan": the plain form below, one lax.scan over anchors with the
    rings as (J, Q) carries. It is the CPU implementation and the
    reference the GPU kernels are checked against.
  * "cuda": the kernels of native/chain_ring.cu (ops/chain_cuda), one
    warp per query row running the whole anchor loop on the device.

backend.decide() picks one per process; the functions here take the
choice as the static `impl` argument.

Gap penalty without a table gather: the reference cost is
``(int)(dd * .01 * avg_qspan) + (ilog2(dd) >> 1)`` evaluated in f64
(chain.c:67). The host finds an 80-bit fixed-point multiplier M with
``floor(dd * M / 2**64) == (int)(dd * .01 * avg_qspan)`` for every
dd <= bw (an interval intersection over exact integer bounds), and the
passes evaluate the floor with five 16-bit limb multiplies in int32.
Rows with an empty intersection are flagged for the exact host
fallback. ilog2 is the f32 exponent field (exact: dd < 2**24).

Layouts: anchors and outputs are (Q, A) int32 (row-major per query);
the carry is seven (J, Q) int32 rings (xh, xl, q, span, f, v, p; row 0
is the newest anchor) plus a (1, Q) int32 flag word.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from longqc_tpu.ops.chain import gap_penalty_table

NEG = -(10 ** 9)
INF32 = np.int32(0x7FFFFFFF)
RING_DEPTHS = (64, 128, 256, 512)


@functools.lru_cache(maxsize=4096)
def penalty_limbs(avg_qspan, bw):
    """(5,) int32 16-bit limbs of M (lsb-first; floor(dd*M >> 64) equals
    the reference linear gap cost for all dd in [0, bw]), or None when
    no single multiplier reproduces the table (host fallback)."""
    if bw >= 32768:
        # int32 limb product ddc*l_j can overflow past 2^31 for
        # bw >= 2^15: punt to the exact host fallback
        return None
    tab = gap_penalty_table(np.float32(avg_qspan), bw).astype(np.int64)
    dd = np.arange(bw + 1)
    log_dd = np.zeros(bw + 1, np.int64)
    log_dd[1:] = np.floor(np.log2(dd[1:])).astype(np.int64)
    lin = tab - (log_dd >> 1)
    m_lo, m_hi = 0, (1 << 80) - 1
    for d in range(1, bw + 1):
        L = int(lin[d])
        lo = ((L << 64) + d - 1) // d
        hi = (((L + 1) << 64) - 1) // d
        if lo > m_lo:
            m_lo = lo
        if hi < m_hi:
            m_hi = hi
    if m_lo > m_hi:
        return None
    M = m_lo
    return np.array([(M >> (16 * j)) & 0xFFFF for j in range(5)], np.int32)


def make_ring_carry(Q, J=64):
    """Fresh fill carry: 7 x (J, Q) int32 rings + (1, Q) int32 flags."""
    zJ = np.zeros((J, Q), np.int32)
    return (zJ - 1, zJ.copy(), zJ.copy(), zJ.copy(), zJ.copy(),
            zJ.copy(), zJ + NEG, np.zeros((1, Q), np.int32))


# ---------------------------------------------------------------------------
# plain forms: one lax.scan step per anchor over (J, Q) rings


def _shift(x, k, fill):
    """Ring (J, Q) aged by k: out[a] = x[a - k], `fill` for a < k."""
    pad = jnp.full((k,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([pad, x[:-k]], axis=0)


def _iscan(x, op, identity):
    """Inclusive scan over the age axis (Hillis-Steele)."""
    k = 1
    while k < x.shape[0]:
        x = op(x, _shift(x, k, identity))
        k *= 2
    return x


def _push(ring, val):
    return jnp.concatenate([val, ring[:-1]], axis=0)


def _fill_scan(axh, axl, aq, asp, nb, limbs, rbad, carry, i0, *, J,
               max_dist, bw, max_skip):
    """(A, Q) anchors -> (A, Q) f/p/v and the carry after the chunk."""
    Q = nb.shape[1]
    NEGj = np.int32(NEG)
    one = np.int32(1)
    ages = jax.lax.broadcasted_iota(jnp.int32, (J, Q), 0) + 1
    l0, l1, l2, l3, l4 = (limbs[j:j + 1, :] for j in range(5))
    cxh, cxl, cq, cs, cf, cv, cp, cfl = carry
    # rows with no exact penalty multiplier are host-fallback
    fl0 = cfl | (rbad & jnp.where(nb > 0, one, np.int32(0)))

    def body(c, x):
        rxh, rxl, rq, rs, rf, rv, rp, rfl = c
        i, xh_i, xl_i, q_i, s_i = x
        xh_i, xl_i, q_i, s_i = (a[None, :] for a in (xh_i, xl_i, q_i, s_i))
        row_on = i < nb

        exists = (i - ages) >= 0
        dr = xl_i - rxl
        dr_ok = (xh_i == rxh) & (dr >= 0) & (dr <= max_dist)
        dq = q_i - rq
        valid = exists & dr_ok & (dr != 0) & (dq > 0) & (dq <= max_dist)
        dd = jnp.abs(dr - dq)
        valid = valid & (dd <= bw)

        # exact gap penalty: floor(dd * M / 2^64) + (ilog2(dd) >> 1)
        ddc = jnp.clip(dd, 0, bw)
        t = ddc * l3 + ((ddc * l2 + ((ddc * l1
             + ((ddc * l0) >> 16)) >> 16)) >> 16)
        lin = ddc * l4 + (t >> 16)
        ex = jax.lax.shift_right_logical(
            jax.lax.bitcast_convert_type(ddc.astype(jnp.float32),
                                         jnp.int32), np.int32(23)) - 127
        pen = lin + (jnp.where(ddc > 0, ex, 0) >> 1)

        sc0 = jnp.minimum(jnp.minimum(dq, dr), s_i)
        sc = jnp.where(valid, sc0 - pen + rf, NEGj)
        inc = _iscan(sc, jnp.maximum, NEGj)
        run_before = jnp.maximum(_shift(inc, 1, NEGj), s_i)
        newmax = valid & (sc > run_before)

        tgt_age = i - rp
        rp_real = rp > NEG + J + 1

        def marks_from(src_mask):
            # ages whose slot is someone's parent, via J/32 32-bit mark
            # words (word w covers target ages in (32w, 32w + 32])
            ok = src_mask & rp_real & (tgt_age >= 1) & (tgt_age <= J)
            t0 = jnp.clip(tgt_age - 1, 0, J - 1)
            sel = jnp.zeros_like(tgt_age)
            for wd in range(J // 32):
                bit = jnp.where(
                    ok & (t0 >= 32 * wd) & (t0 < 32 * (wd + 1)),
                    jax.lax.shift_left(one, jnp.clip(t0 - 32 * wd, 0, 31)),
                    0)
                word = jax.lax.reduce(bit, np.int32(0),
                                      jax.lax.bitwise_or, (0,))[None, :]
                sel = jnp.where(
                    (ages > 32 * wd) & (ages <= 32 * (wd + 1)),
                    jax.lax.shift_right_logical(
                        word, jnp.clip(ages - 1 - 32 * wd, 0, 31)),
                    sel)
            return (sel & 1) == 1

        def walk_cut(marks):
            skipev = valid & ~newmax & marks
            delta = jnp.where(skipev, one,
                              jnp.where(newmax, np.int32(-1), np.int32(0)))
            S = _iscan(delta, jnp.add, np.int32(0))
            minS = _iscan(S, jnp.minimum, np.int32(2 ** 30))
            walk = S - jnp.minimum(0, minS)
            brk = skipev & (walk > max_skip)
            return jnp.min(jnp.where(brk, ages, J + 1), axis=0,
                           keepdims=True)

        cut0 = walk_cut(marks_from(valid))
        cut1 = walk_cut(marks_from(valid & (ages < cut0)))
        disagree = cut0 != cut1

        nm_in = newmax & (ages <= cut1)
        p_age = jnp.max(jnp.where(nm_in, ages, 0), axis=0, keepdims=True)
        has_pred = p_age > 0
        f_i = jnp.where(
            has_pred,
            jnp.max(jnp.where(nm_in, sc, NEGj), axis=0, keepdims=True),
            s_i)
        p_abs = jnp.where(has_pred, i - p_age, NEGj)
        v_pred = jnp.max(jnp.where(ages == p_age, rv, NEGj), axis=0,
                         keepdims=True)
        v_i = jnp.where(has_pred & (v_pred > f_i), v_pred, f_i)

        oldest_ok = exists[J - 1:J, :] & dr_ok[J - 1:J, :]
        trunc = (cut1 > J) & oldest_ok
        rfl = rfl | jnp.where(row_on & (disagree | trunc), one,
                              np.int32(0))
        c = (_push(rxh, xh_i), _push(rxl, xl_i), _push(rq, q_i),
             _push(rs, s_i), _push(rf, f_i), _push(rv, v_i),
             _push(rp, p_abs), rfl)
        out = (jnp.where(row_on, f_i, 0)[0],
               jnp.where(row_on, jnp.maximum(p_abs, -1), -1)[0],
               jnp.where(row_on, v_i, 0)[0])
        return c, out

    A = axh.shape[0]
    idx = i0 + jnp.arange(A, dtype=jnp.int32)
    c, (f, p, v) = jax.lax.scan(
        body, (cxh, cxl, cq, cs, cf, cv, cp, fl0),
        (idx, axh, axl, aq, asp))
    return (f, p, v) + tuple(c)


def _peak_scan(f, v, p, *, J):
    """(A, Q) f/v/p -> (A, Q) peak (absolute anchor indices)."""
    A, Q = f.shape
    ages = jax.lax.broadcasted_iota(jnp.int32, (J, Q), 0) + 1

    def body(rpk, x):
        i, f_i, v_i, p_i = x
        tgt_age = (i - p_i)[None, :]
        sel = jnp.max(jnp.where(ages == tgt_age, rpk, -1), axis=0)
        walk = (v_i > f_i) & (p_i >= 0) & (tgt_age[0] <= J)
        peak_i = jnp.where(walk, sel, i)
        return _push(rpk, peak_i[None, :]), peak_i

    _, pk = jax.lax.scan(body, jnp.full((J, Q), -1, jnp.int32),
                         (jnp.arange(A, dtype=jnp.int32), f, v, p))
    return pk


def _minrank_scan(p, own, *, J):
    """(A, Q) p/own_rank -> (A, Q) min-rank, swept from the last
    anchor back (INF32 where the anchor is on no candidate chain)."""
    A, Q = p.shape

    def body(c, x):
        rr, rp = c
        i, p_i, own_i = x
        cand = jnp.min(jnp.where(rp == i, rr, INF32), axis=0)
        r_i = jnp.minimum(own_i, cand)
        return (_push(rr, r_i[None, :]), _push(rp, p_i[None, :])), r_i

    init = (jnp.full((J, Q), INF32, jnp.int32),
            jnp.full((J, Q), -2, jnp.int32))
    _, r = jax.lax.scan(body, init,
                        (jnp.arange(A, dtype=jnp.int32), p, own),
                        reverse=True)
    return r


# ---------------------------------------------------------------------------
# dispatch (impl is static: "scan" or "cuda")


def _check_j(J):
    assert J in RING_DEPTHS, \
        "mark words and scans support J = 64 and the 128/256/512 rungs"


@functools.partial(jax.jit, static_argnames=(
    "J", "max_dist", "bw", "max_skip", "impl"))
def chain_fill(axh, axl, aq, asp, nb, limbs, rbad, carry, i0, *, J,
               max_dist, bw, max_skip, impl):
    """Batched resumable chain-DP fill.

    axh/axl/aq/asp: (Q, A) int32 anchor keys (rev << 24 | rid, target
    position), query positions and spans, row-sorted; nb: (Q,) total
    anchors per row; limbs: (5, Q) penalty multiplier limbs; rbad:
    (Q,) rows with no exact multiplier; carry: make_ring_carry() or a
    previous chunk's; i0: absolute index of this chunk's first anchor.

    Returns f, p, v as (Q, A) int32 (p absolute, -1 = none) and the
    8-tuple carry after the chunk (carry[-1] != 0 flags a row).
    """
    _check_j(J)
    nb = nb.reshape(1, -1).astype(jnp.int32)
    rbad = rbad.reshape(1, -1).astype(jnp.int32)
    i0 = jnp.asarray(i0, jnp.int32)
    carry = tuple(jnp.asarray(c, jnp.int32) for c in carry)
    kw = dict(J=J, max_dist=max_dist, bw=bw, max_skip=max_skip)
    if impl == "cuda":
        from longqc_tpu.ops import chain_cuda
        return chain_cuda.fill(axh, axl, aq, asp, nb, limbs, rbad, carry,
                               i0, **kw)
    f, p, v, *c = _fill_scan(axh.T, axl.T, aq.T, asp.T, nb, limbs, rbad,
                             carry, i0, **kw)
    return (f.T, p.T, v.T) + tuple(c)


@functools.partial(jax.jit, static_argnames=("J", "impl"))
def peak_pass(f, v, p, *, J, impl):
    """(Q, A) int32 f/v/p -> (Q, A) int32 peak (absolute indices).

    Rows whose parents escape the J ring produce garbage; the fill has
    already flagged such rows and the host fallback replaces them."""
    _check_j(J)
    if impl == "cuda":
        from longqc_tpu.ops import chain_cuda
        return chain_cuda.peak(f, v, p, J=J)
    return _peak_scan(f.T, v.T, p.T, J=J).T


@functools.partial(jax.jit, static_argnames=("J", "impl"))
def minrank_pass(p, own_rank, *, J, impl):
    """(Q, A) int32 p/own_rank -> (Q, A) int32 min-rank (INF32 where
    the anchor is on no candidate chain's path)."""
    _check_j(J)
    if impl == "cuda":
        from longqc_tpu.ops import chain_cuda
        return chain_cuda.minrank(p, own_rank, J=J)
    return _minrank_scan(p.T, own_rank.T, J=J).T
