"""Canonical-shape device index build: differential tests.

- packed multi-read rows sketch identically to standalone reads
  (segment-gated rules in ops/sketch._sketch_core)
- merge_sorted == numpy mergesort
- build_device_index reproduces the host MinimizerIndex arrays
  (same (hash, rid, ps) multiset grouped by hash, same mid_occ)
"""
import numpy as np
import pytest

from longqc_tpu.engine import device_index as di
from longqc_tpu.engine import overlap_host as oh
from longqc_tpu.ops.chain_ring import INF32

import jax.numpy as jnp


def _rand_reads(rng, n, lo, hi, with_n=True):
    reads = []
    for i in range(n):
        ln = rng.randint(lo, hi)
        s = "".join("ACGT"[j] for j in rng.randint(0, 4, ln))
        if with_n and ln > 10 and rng.rand() < 0.5:
            p = rng.randint(0, ln - 5)
            s = s[:p] + "N" * rng.randint(1, 4) + s[p + 3:]
        reads.append(["r%04d" % i, s, ""])
    return reads


def _flat_from_host(part, k, w):
    """(hash, rid, ps) triples via the validated per-read host path."""
    sk = oh.sketch_reads_device(part, k, w)
    out = []
    for rid, (hh, pp, ss, _sp) in enumerate(sk):
        for h, p, s in zip(hh, pp, ss):
            out.append((np.int32(np.uint32(h)), rid,
                        (int(p) << 1) | int(s)))
    return out


@pytest.mark.parametrize("k,w", [(12, 5), (15, 5), (12, 10)])
def test_packed_tiles_match_per_read(k, w):
    rng = np.random.RandomState(7)
    part = _rand_reads(rng, 40, 30, 900)
    tiles, jumbo = di.pack_part_tiles(part, w,
                                      ladder=di.TILE_LADDER_SMALL)
    assert not jumbo
    got = []
    for t in tiles:
        ih, irid, ips, n_exp, row_ov, exp_ov = di._run_tile(t, k, w)
        assert not bool(np.asarray(exp_ov))
        assert not np.asarray(row_ov).any()
        ih = np.asarray(ih)
        keep = ih != INF32
        got.extend(zip(ih[keep].tolist(),
                       np.asarray(irid)[keep].tolist(),
                       np.asarray(ips)[keep].tolist()))
    want = _flat_from_host(part, k, w)
    assert sorted(got) == sorted(want)


def test_merge_sorted_matches_numpy():
    rng = np.random.RandomState(3)
    n = 1 << 10
    for trial in range(4):
        ka = np.sort(rng.randint(-50, 50, n).astype(np.int32))
        kb = np.sort(rng.randint(-50, 50, n).astype(np.int32))
        # INF-pad some of the tail
        ka[n - rng.randint(0, n // 2):] = INF32
        kb[n - rng.randint(0, n // 2):] = INF32
        pa = np.arange(n, dtype=np.int32)
        pb = np.arange(n, dtype=np.int32) + 1000000
        ko, p1, p2 = di.merge_sorted(
            jnp.asarray(ka), jnp.asarray(pa), jnp.asarray(pa),
            jnp.asarray(kb), jnp.asarray(pb), jnp.asarray(pb), n=n)
        ko = np.asarray(ko)
        assert (np.diff(ko) >= 0).all()
        assert sorted(ko.tolist()) == sorted(
            ka.tolist() + kb.tolist())
        # stability: among equal keys A payloads come first
        p1 = np.asarray(p1)
        for v in np.unique(ko[ko != INF32]):
            pay = p1[ko == v]
            a_part = pay[pay < 1000000]
            b_part = pay[pay >= 1000000]
            assert (sorted(pay.tolist())
                    == a_part.tolist() + b_part.tolist())


@pytest.mark.parametrize("k,w", [(12, 5), (15, 5)])
def test_build_device_index_matches_host(k, w):
    rng = np.random.RandomState(11)
    part = _rand_reads(rng, 120, 40, 1500)
    idx = di.build_device_index(part, k, w,
                                ladder=di.TILE_LADDER_SMALL,
                                n_idx_sizes=di.N_IDX_SIZES_SMALL)
    hidx = oh.build_index(part, k, w)
    ih = np.asarray(idx["ih"])
    keep = ih != INF32
    got = sorted(zip(ih[keep].tolist(),
                     np.asarray(idx["irid"])[keep].tolist(),
                     np.asarray(idx["ips"])[keep].tolist()))
    want = sorted(zip(hidx.h.astype(np.uint32).astype(np.int32).tolist(),
                      hidx.rid.tolist(), hidx.ps.tolist()))
    assert got == want
    assert int(idx["mid_occ"]) == hidx.mid_occ(2e-4)


def test_build_device_index_mid_occ_frac():
    rng = np.random.RandomState(5)
    # heavy duplication so the quantile is non-trivial
    core = "".join("ACGT"[j] for j in rng.randint(0, 4, 300))
    part = [["c%d" % i, core, ""] for i in range(30)]
    part += _rand_reads(rng, 20, 50, 400)
    for frac in (0.5, 0.1, 2e-4):
        idx = di.build_device_index(part, 12, 5,
                                    ladder=di.TILE_LADDER_SMALL,
                                    n_idx_sizes=di.N_IDX_SIZES_SMALL,
                                    mid_occ_frac=frac)
        hidx = oh.build_index(part, 12, 5)
        assert int(idx["mid_occ"]) == hidx.mid_occ(frac), frac
