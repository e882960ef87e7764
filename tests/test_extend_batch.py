"""ksw2-class extension (ops/extend.extz_batch, plain lax) vs the
full-DP host oracle extz_host: extz single-gap and extd dual-gap
semantics, every output the oracle reports, with and without z-drop."""

import numpy as np

from longqc_tpu.ops.adapter import encode
from longqc_tpu.ops.extend import extz_batch, extz_host

from test_extend import _mutate


def _make_pairs(rng, B, Lq, Lt):
    qs = np.full((B, Lq), 4, np.int32)
    ts = np.full((B, Lt), 4, np.int32)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    pairs = []
    for b in range(B):
        base = "".join("ACGT"[i]
                       for i in rng.randint(0, 4, rng.randint(60, Lq - 5)))
        kind = b % 5
        if kind == 0:
            other = _mutate(rng, base, 0.1)
        elif kind == 1:
            other = "".join("ACGT"[i]
                            for i in rng.randint(0, 4, len(base)))
        elif kind == 2:
            other = _mutate(rng, base[: len(base) // 2], 0.05)
        elif kind == 3:
            # long deletion: exercises the second gap family under extd
            cut = len(base) // 3
            other = base[:cut] + base[cut + 40:]
        else:
            other = base
        qc, tc = encode(base)[:Lq], encode(other)[:Lt]
        qs[b, :len(qc)] = qc
        ts[b, :len(tc)] = tc
        qlens[b], tlens[b] = len(qc), len(tc)
        pairs.append((qc, tc))
    return qs, qlens, ts, tlens, pairs


def _check_vs_host(res, pairs, W, **gap):
    for b, (qc, tc) in enumerate(pairs):
        want = extz_host(qc, tc, w=W, **gap)
        assert int(res["max"][b]) == want["max"], (b, int(res["max"][b]),
                                                   want["max"])
        assert int(res["max_q"][b]) == want["max_q"], b
        assert int(res["max_t"][b]) == want["max_t"], b
        if want["mqe"] > -(10 ** 8):
            assert int(res["mqe"][b]) == want["mqe"], b


def test_extz_batch_matches_host():
    rng = np.random.RandomState(11)
    B, Lq, Lt, W = 10, 192, 192, 32
    qs, qlens, ts, tlens, pairs = _make_pairs(rng, B, Lq, Lt)
    res = extz_batch(qs, qlens, ts, tlens, W=W, Lq=Lq, Lt=Lt)
    _check_vs_host(res, pairs, W)


def test_extd_batch_matches_host():
    """Dual-gap (ksw_extd) scoring, minimap2 default long-gap params."""
    rng = np.random.RandomState(12)
    B, Lq, Lt, W = 10, 192, 192, 48
    gap = dict(gapo2=24, gape2=1)
    qs, qlens, ts, tlens, pairs = _make_pairs(rng, B, Lq, Lt)
    res = extz_batch(qs, qlens, ts, tlens, W=W, Lq=Lq, Lt=Lt, **gap)
    _check_vs_host(res, pairs, W, **gap)


def test_extd_scan_matches_host():
    rng = np.random.RandomState(13)
    B, Lq, Lt, W = 8, 160, 160, 40
    gap = dict(gapo2=24, gape2=1)
    qs, qlens, ts, tlens, pairs = _make_pairs(rng, B, Lq, Lt)
    res = extz_batch(qs, qlens, ts, tlens, W=W, Lq=Lq, Lt=Lt, **gap)
    for b, (qc, tc) in enumerate(pairs):
        want = extz_host(qc, tc, w=W, **gap)
        assert int(np.asarray(res["max"])[b]) == want["max"], b
        assert int(np.asarray(res["max_q"])[b]) == want["max_q"], b
        assert int(np.asarray(res["max_t"])[b]) == want["max_t"], b


def test_extz_batch_full_outputs_with_zdrop():
    """Every output the oracle reports (incl. mqe_t, mte and mte_q)
    matches under an aggressive z-drop, which cuts the unrelated
    pairs' extension short."""
    rng = np.random.RandomState(14)
    B, Lq, Lt, W = 16, 224, 224, 63
    qs, qlens, ts, tlens, pairs = _make_pairs(rng, B, Lq, Lt)
    got = extz_batch(qs, qlens, ts, tlens, W=W, Lq=Lq, Lt=Lt, zdrop=100)
    for b, (qc, tc) in enumerate(pairs):
        want = extz_host(qc, tc, w=W, zdrop=100)
        for key in ("max", "max_q", "max_t", "mqe", "mqe_t", "mte",
                    "mte_q"):
            assert int(np.asarray(got[key])[b]) == want[key], (b, key)
