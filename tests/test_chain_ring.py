"""Chain ring passes (ops/chain_ring): the plain lax.scan forms against
ops/chain's validated fill, the host fill and the ops/chainsel spec,
plus CPU checks of the CUDA route's wrapper (shapes, padding, route
choice). Bit-identical f/p/v/flags/carry are required, including
across chunk-resume boundaries. The kernels themselves run only on the
GPU (the `gpu` tests here, and chip_smoke.py)."""

import numpy as np
import pytest

from longqc_tpu import backend
from longqc_tpu.ops import chain_ring as cr
from longqc_tpu.ops.chain import (chain_dp_batch, gap_penalty_table,
                                  make_carry)
from longqc_tpu.ops.chain_ring import make_ring_carry, penalty_limbs
from longqc_tpu.ops.chainsel import INF_RANK, chain_ranks, compute_peaks

KW = dict(max_dist=10000, bw=500, max_skip=25)


def _fill(axh, axl, aqb, asb, nb, limbs, rbad, carry, i0, J=64,
          impl="scan"):
    out = cr.chain_fill(axh, axl, aqb, asb, nb, limbs, rbad, carry, i0,
                        J=J, impl=impl, **KW)
    f, p, v, *c = (np.asarray(x) for x in out)
    return f, p, v, c[-1].reshape(-1) != 0, tuple(c)


def test_penalty_limbs_exact():
    bw = 500
    rng = np.random.RandomState(5)
    avgs = np.concatenate([
        rng.uniform(10.0, 26.0, 200),
        rng.uniform(1.0, 200.0, 100),
        [12.0, 15.0, 19.0, 25.5, 0.01]]).astype(np.float32)
    dd = np.arange(bw + 1)
    log_dd = np.zeros(bw + 1, np.int64)
    log_dd[1:] = np.floor(np.log2(dd[1:])).astype(np.int64)
    n_bad = 0
    for avg in avgs:
        limbs = penalty_limbs(float(avg), bw)
        if limbs is None:
            n_bad += 1
            continue
        tab = gap_penalty_table(avg, bw).astype(np.int64)
        M = sum(int(limbs[j]) << (16 * j) for j in range(5))
        lin = np.array([(int(d) * M) >> 64 for d in dd], np.int64)
        assert np.array_equal(lin + (log_dd >> 1), tab), avg
    assert n_bad == 0  # empty intersections should be ~measure-zero


def _rand_rows(rng, Q, A, n_lo, n_hi):
    """Random anchor rows with realistic structure: sorted target
    positions within a couple of (rid, rev) groups, clustered diagonals
    so chains and skip events actually occur."""
    axh = np.zeros((Q, A), np.int32)
    axl = np.zeros((Q, A), np.int32)
    aqb = np.zeros((Q, A), np.int32)
    asb = np.zeros((Q, A), np.int32)
    nb = np.zeros((Q,), np.int32)
    for r in range(Q):
        n = rng.randint(n_lo, n_hi)
        nb[r] = n
        n_grp = rng.randint(1, 4)
        grp = np.sort(rng.randint(0, n_grp, n))
        pos = np.sort(rng.randint(0, 20000, n)).astype(np.int64)
        diag = rng.randint(0, 3, n) * rng.randint(1, 400)
        q = pos - 5000 + diag + rng.randint(-40, 40, n)
        axh[r, :n] = grp
        axl[r, :n] = pos
        aqb[r, :n] = np.clip(q, 0, None)
        asb[r, :n] = 12
    return axh, axl, aqb, asb, nb


def _limbs_for(asb, nb, bw=500):
    Q = len(nb)
    limbs = np.zeros((5, Q), np.int32)
    rbad = np.zeros((Q,), np.int32)
    for r in range(Q):
        lb = penalty_limbs(float(np.float32(asb[r, :nb[r]].sum() / nb[r])),
                           bw)
        if lb is None:
            rbad[r] = 1
        else:
            limbs[:, r] = lb
    return limbs, rbad


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_matches_chain_scan(seed):
    """The (J, Q)-ring fill with penalty limbs == ops/chain's (Q, J)
    fill with the exact f64 penalty table, carry included."""
    rng = np.random.RandomState(seed)
    Q, A, J, bw = 128, 512, 64, 500
    axh, axl, aqb, asb, nb = _rand_rows(rng, Q, A, 40, A)
    pen = np.zeros((Q, bw + 1), np.int32)
    for r in range(Q):
        pen[r] = gap_penalty_table(
            np.float32(asb[r, :nb[r]].sum() / nb[r]), bw)
    limbs, rbad = _limbs_for(asb, nb, bw)

    f0, p0, v0, fl0, c0 = chain_dp_batch(
        axh, axl, aqb, asb, nb, pen, make_carry(Q, J), np.int32(0))
    f1, p1, v1, fl1, c1 = _fill(axh, axl, aqb, asb, nb, limbs, rbad,
                                make_ring_carry(Q, J), 0)

    f0, p0, v0, fl0 = map(np.asarray, (f0, p0, v0, fl0))
    assert np.array_equal(f0, f1)
    assert np.array_equal(p0, p1)
    assert np.array_equal(v0, v1)
    assert rbad.sum() == 0
    assert np.array_equal(fl0, fl1)
    # carry equality (transposed layout)
    for a, b in zip(c0[:7], c1[:7]):
        assert np.array_equal(np.asarray(a).T, b)
    assert np.array_equal(np.asarray(c0[7]), c1[7].reshape(-1) != 0)
    assert fl0.sum() < Q  # most rows exact on device


def test_fill_chunk_resume():
    """Chunked calls with carry == one monolithic call."""
    rng = np.random.RandomState(7)
    Q, A, J = 128, 512, 64
    axh, axl, aqb, asb, nb = _rand_rows(rng, Q, A, A // 2, A)
    limbs, rbad = _limbs_for(asb, nb)

    f0, p0, v0, fl0, _ = _fill(axh, axl, aqb, asb, nb, limbs, rbad,
                               make_ring_carry(Q, J), 0)

    carry = make_ring_carry(Q, J)
    H = A // 2
    f1 = np.zeros((Q, A), np.int32)
    p1 = np.zeros((Q, A), np.int32)
    v1 = np.zeros((Q, A), np.int32)
    fl1 = np.zeros((Q,), bool)
    for c0_ in (0, H):
        fa, pa, va, fla, carry = _fill(
            axh[:, c0_:c0_ + H], axl[:, c0_:c0_ + H],
            aqb[:, c0_:c0_ + H], asb[:, c0_:c0_ + H],
            nb, limbs, rbad, carry, c0_)
        f1[:, c0_:c0_ + H] = fa
        p1[:, c0_:c0_ + H] = pa
        v1[:, c0_:c0_ + H] = va
        fl1 |= fla
    assert np.array_equal(f0, f1)
    assert np.array_equal(p0, p1)
    assert np.array_equal(v0, v1)
    assert np.array_equal(fl0, fl1)


def _dense_rows(rng, Q, A):
    axh = np.zeros((Q, A), np.int32)
    axl = np.zeros((Q, A), np.int32)
    aqb = np.zeros((Q, A), np.int32)
    asb = np.zeros((Q, A), np.int32)
    nb = np.zeros((Q,), np.int32)
    for r in range(Q):
        # the truncation regime: >64 anchors inside max_dist whose
        # pairings are mostly invalid (dd > bw), so no max_skip break
        # ever bounds the scan — the reference walks all the way back
        # (what (AT)n microsatellite reads produce); a thin diagonal
        # subset keeps f/p/v nontrivial
        n = rng.randint(70, 121)
        nb[r] = n
        pos = np.sort(rng.randint(0, 3000, n)).astype(np.int64)
        q = rng.randint(0, 20000, n).astype(np.int64)
        diag = rng.rand(n) < 0.2
        q[diag] = np.clip(pos[diag] + rng.randint(-50, 50, diag.sum()),
                          0, None)
        axl[r, :n] = pos
        aqb[r, :n] = q
        asb[r, :n] = 12
    return axh, axl, aqb, asb, nb


def test_fill_j128_unflags_repeat_dense_rows():
    """Repeat-dense rows (every anchor within max_dist of every other)
    overflow the J=64 predecessor ring and flag; the J=128 escalation
    rung must clear most of them AND be bit-exact vs the sequential
    host fill (chain.c:41-80 semantics, host_fill in test_chain)."""
    from test_chain import host_fill

    rng = np.random.RandomState(11)
    Q, A, bw = 128, 256, 500
    axh, axl, aqb, asb, nb = _dense_rows(rng, Q, A)
    limbs = np.repeat(penalty_limbs(12.0, bw)[:, None], Q, axis=1)
    rbad = np.zeros((Q,), np.int32)

    fl64 = _fill(axh, axl, aqb, asb, nb, limbs, rbad,
                 make_ring_carry(Q, 64), 0, J=64)[3]
    f, p, v, fl128, _ = _fill(axh, axl, aqb, asb, nb, limbs, rbad,
                              make_ring_carry(Q, 128), 0, J=128)
    assert fl64.sum() > Q // 2       # dense rows truncate the 64-ring
    assert fl128.sum() < fl64.sum() // 4
    for r in range(Q):
        if fl128[r]:
            continue
        n = int(nb[r])
        ax = axl[r, :n].astype(np.uint64)
        ay = (np.uint64(12) << np.uint64(32)) | \
            aqb[r, :n].astype(np.uint64)
        fh, ph, vh = host_fill(ax, ay, 10000, bw, 25)
        assert np.array_equal(f[r, :n], fh)
        assert np.array_equal(p[r, :n], ph)
        assert np.array_equal(v[r, :n], vh)


def _random_forest(rng, n, J):
    f = rng.randint(1, 200, size=n).astype(np.int64)
    p = np.full(n, -1, np.int64)
    v = f.copy()
    for i in range(n):
        if i > 0 and rng.rand() < 0.85:
            p[i] = rng.randint(max(0, i - J), i)
            v[i] = max(f[i], v[p[i]])
    return f, p, v


@pytest.mark.parametrize("J", [64, 256])
def test_peak_and_minrank_pass_match_spec(J):
    rng = np.random.RandomState(5)
    Q, A = 8, 512
    fs = np.zeros((Q, A), np.int32)
    ps = np.full((Q, A), -1, np.int32)
    vs = np.zeros((Q, A), np.int32)
    owns = np.full((Q, A), INF_RANK, np.int32)
    ns = []
    expect_peak, expect_rank = [], []
    for q in range(Q):
        n = rng.randint(1, A + 1)
        ns.append(n)
        f, p, v = _random_forest(rng, n, J)
        fs[q, :n] = f
        ps[q, :n] = p
        vs[q, :n] = v
        expect_peak.append(compute_peaks(f, p, v))
        rank, order = chain_ranks(f, p, v, n, min_sc=30)
        expect_rank.append(rank)
        own = np.full(n, INF_RANK, np.int64)
        own[order] = np.arange(len(order))
        owns[q, :n] = own

    pk = np.asarray(cr.peak_pass(fs, vs, ps, J=J, impl="scan"))
    mr = np.asarray(cr.minrank_pass(ps, owns, J=J, impl="scan"))
    for q in range(Q):
        n = ns[q]
        assert np.array_equal(pk[q, :n], expect_peak[q]), q
        assert np.array_equal(mr[q, :n], expect_rank[q]), q


def test_fill_padding_rows_and_ragged_width():
    """Anchors past a row's count come back as (f, p, v) = (0, -1, 0)
    and do not touch the flags; A need not be a multiple of the
    kernel's 32-anchor loads (ragged tail)."""
    rng = np.random.RandomState(3)
    Q, A = 16, 100
    axh, axl, aqb, asb, nb = _rand_rows(rng, Q, A, 5, A)
    nb[0] = 0
    limbs, rbad = _limbs_for(asb, np.maximum(nb, 1))
    rbad[1] = 1     # no exact multiplier: flagged only if it has anchors
    nb[2] = 0
    rbad[2] = 1
    f, p, v, fl, c = _fill(axh, axl, aqb, asb, nb, limbs, rbad,
                           make_ring_carry(Q, 64), 0)
    assert f.shape == p.shape == v.shape == (Q, A)
    for r in range(Q):
        n = nb[r]
        assert not f[r, n:].any() and not v[r, n:].any()
        assert (p[r, n:] == -1).all()
    assert fl[1] and not fl[0] and not fl[2]
    assert [x.shape for x in c] == [(64, Q)] * 7 + [(1, Q)]


def test_cuda_route_wrapper_shapes(monkeypatch):
    """The CUDA route's jax.ffi calls trace to the plain forms' output
    shapes and dtypes at every ring depth (shape inference only: the
    library is built and registered on the GPU)."""
    import jax
    from longqc_tpu.ops import chain_cuda

    monkeypatch.setattr(chain_cuda, "register", lambda: None)
    Q, A = 128, 1024
    i32 = np.int32
    sd = jax.ShapeDtypeStruct
    anch = [sd((Q, A), i32)] * 4
    for J in cr.RING_DEPTHS:
        carry = tuple(sd(c.shape, i32) for c in make_ring_carry(Q, J))
        args = anch + [sd((Q,), i32), sd((5, Q), i32), sd((Q,), i32),
                       carry, sd((), i32)]
        got = {}
        for impl in ("cuda", "scan"):
            out = jax.eval_shape(
                lambda *a, impl=impl: cr.chain_fill(*a, J=J, impl=impl,
                                                    **KW), *args)
            pk = jax.eval_shape(
                lambda f, v, p, impl=impl: cr.peak_pass(f, v, p, J=J,
                                                        impl=impl),
                *anch[:3])
            mr = jax.eval_shape(
                lambda p, o, impl=impl: cr.minrank_pass(p, o, J=J,
                                                        impl=impl),
                *anch[:2])
            got[impl] = [(x.shape, x.dtype) for x in
                         list(out) + [pk, mr]]
        assert got["cuda"] == got["scan"], J
        assert len(got["cuda"]) == 13


def test_backend_route_choice():
    """On the CPU the decision is the plain forms and the small
    geometry; use() swaps fields for a block only."""
    be = backend.decide()
    assert be == backend.CPU
    assert be.chain == "scan" and be.geometry == "small"
    assert backend.GPU.chain == "cuda" and backend.GPU.geometry == "big"
    with backend.use(chain="cuda") as b2:
        assert backend.decide() is b2 and b2.chain == "cuda"
        assert b2.geometry == be.geometry
    assert backend.decide() == backend.CPU
    with pytest.raises(AssertionError):
        cr.peak_pass(np.zeros((1, 32), np.int32),
                     np.zeros((1, 32), np.int32),
                     np.zeros((1, 32), np.int32), J=32, impl="scan")


@pytest.mark.gpu
@pytest.mark.parametrize("J", cr.RING_DEPTHS)
def test_cuda_matches_scan(gpu, J):
    """On the card: the CUDA fill and ring passes == the plain forms."""
    rng = np.random.RandomState(J)
    Q, A = 128, 1024
    axh, axl, aqb, asb, nb = _rand_rows(rng, Q, A, 40, A)
    limbs, rbad = _limbs_for(asb, nb)
    outs = {}
    for impl in ("cuda", "scan"):
        f, p, v, fl, c = _fill(axh, axl, aqb, asb, nb, limbs, rbad,
                               make_ring_carry(Q, J), 0, J=J, impl=impl)
        pk = np.asarray(cr.peak_pass(f, v, p, J=J, impl=impl))
        own = np.where(f > 40, np.arange(A, dtype=np.int32) % 97,
                       INF_RANK).astype(np.int32)
        mr = np.asarray(cr.minrank_pass(p, own, J=J, impl=impl))
        outs[impl] = [f, p, v, pk, mr] + list(c)
    for a, b in zip(outs["cuda"], outs["scan"]):
        assert np.array_equal(a, b)
