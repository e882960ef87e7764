"""Row identity of the device-resident overlap engine vs the host spec
(on the CPU the chain passes run as their plain forms; chip_smoke.py
checks the GPU kernels against the same spec)."""

import numpy as np
import pytest

from longqc_tpu.config import OverlapConfig, IndexOpt, MapOpt, FltOpt
from longqc_tpu.engine import overlap_host as oh
from longqc_tpu.engine.device_overlap import (DeviceOverlapEngine,
                                              overlap_run_device2)
from util_synth import make_genome, sample_reads


def _cfg(**kw):
    return OverlapConfig(index=IndexOpt(k=12, w=5),
                         map=MapOpt(min_score_med=80, min_score_good=160),
                         flt=FltOpt(min_ovlp=0), **kw)


def test_device2_rows_match_host_small():
    rng = np.random.RandomState(11)
    genome = make_genome(rng, 30000)
    reads = sample_reads(rng, genome, 150, min_len=700, max_len=2200,
                         err=0.12, junk_frac=0.1)
    queries = reads[:40]
    cfg = _cfg()
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    rows_dev = overlap_run_device2(list(reads), queries, cfg)
    assert rows_dev == rows_host


def test_device2_rows_match_host_multipart():
    rng = np.random.RandomState(23)
    genome = make_genome(rng, 25000)
    reads = sample_reads(rng, genome, 160, min_len=600, max_len=2000,
                         err=0.13, junk_frac=0.15)
    queries = reads[:30]
    cfg = _cfg()
    cfg.index.batch_size = 60_000  # force several index parts
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    eng = DeviceOverlapEngine(cfg, queries)
    rows_dev = eng.run(list(reads))
    assert rows_dev == rows_host
    assert eng.n_device_calls >= 2


def test_device2_high_coverage_repeats():
    # repeat-rich genome: stresses occurrence thresholds, multiplicity
    # (tie emissions), interval compression, and the min-rank selection
    rng = np.random.RandomState(7)
    core = make_genome(rng, 3000)
    genome = core * 6 + make_genome(rng, 4000)
    reads = sample_reads(rng, genome, 220, min_len=500, max_len=1800,
                         err=0.08, junk_frac=0.05)
    queries = reads[:25]
    cfg = _cfg()
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    eng = DeviceOverlapEngine(cfg, queries)
    rows_dev = eng.run(list(reads))
    assert rows_dev == rows_host


def test_device2_filter_mode_columns():
    rng = np.random.RandomState(3)
    genome = make_genome(rng, 15000)
    reads = sample_reads(rng, genome, 80, min_len=600, max_len=1500,
                         err=0.1, junk_frac=0.1)
    queries = reads[:16]
    cfg = _cfg(filter_mode=True)
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    rows_dev = overlap_run_device2(list(reads), queries, cfg)
    assert rows_dev == rows_host


def test_geom_ok_exact_f64_semantics():
    # the overhang-ratio comparison must reproduce numpy's f64
    # `a >= total * ratio` bit-exactly for standard ratios, including
    # multiples-of-5 totals where total*0.4 sits ~1e-13 from an integer
    from longqc_tpu.engine.device_overlap import _geom_ok, _ratio_limbs
    from longqc_tpu.engine.device_overlap import StepStatic

    rng = np.random.RandomState(1)
    for ratio in (0.4, 0.5, 0.25, 0.75, 0.3):
        p_hi, p_lo, p_s = _ratio_limbs(ratio)
        st = StepStatic(Q=1, M=1, M2=1, A=256, k=12, max_gap=1, bw=1,
                        max_skip=1, min_cnt=1, min_sc=1, min_sc_m=1,
                        min_sc_g=1, max_overhang=1, min_cov=1, covt=1,
                        ava=False, p_hi=p_hi, p_lo=p_lo, p_s=p_s,
                        chain="scan")
        tot = np.concatenate([
            rng.randint(1, 1 << 30, size=3000),
            np.arange(1, 2000) * 5,          # exact-boundary stress
            np.arange(1, 2000) * 4,
        ]).astype(np.int64)
        # a near the boundary: floor/ceil of total*ratio, +-1
        base = np.floor(tot.astype(np.float64) * ratio).astype(np.int64)
        for off in (-1, 0, 1):
            a = np.maximum(base + off, 1)
            want = a.astype(np.float64) >= tot.astype(np.float64) * ratio
            got, near = _geom_ok(a, tot, st)
            assert not np.asarray(near).any()
            assert np.array_equal(np.asarray(got), want), ratio


def test_device2_hpc_big_k_unsupported():
    # the HPC path packs hash<<8|span into i32 index lanes (k <= 15);
    # no reference surface combines HPC with k > 15
    cfg = OverlapConfig(index=IndexOpt(k=19, w=10, is_hpc=True),
                        map=MapOpt(), flt=FltOpt())
    with pytest.raises(NotImplementedError):
        DeviceOverlapEngine(cfg, [["q", "ACGT" * 100, ""]])


def test_device2_hpc_filter_rows_match_host():
    # the spike-in control filter shape (longQC.py:255): one small
    # target genome indexed with -Hk15 -w10, sample reads as queries,
    # min_coverage=1 + --filter column semantics
    rng = np.random.RandomState(41)
    control = make_genome(rng, 12000)
    reads = sample_reads(rng, control, 70, min_len=600, max_len=1600,
                         err=0.1, junk_frac=0.2)
    cfg = OverlapConfig(index=IndexOpt(k=15, w=10, is_hpc=True),
                        map=MapOpt(),
                        flt=FltOpt(min_ovlp=0, min_coverage=1),
                        filter_mode=True)
    target = [["control", control, ""]]
    rows_host = oh.overlap_run(list(target), reads, cfg)
    eng = DeviceOverlapEngine(cfg, reads)
    rows_dev = eng.run(list(target))
    assert rows_dev == rows_host


def test_device2_hpc_ava_rows_match_host():
    # HPC all-vs-sample with homopolymer-rich reads (spans far from k)
    rng = np.random.RandomState(59)
    base = make_genome(rng, 18000)
    # stretch homopolymers so HPC compression is significant
    genome = "".join(c * (1 + rng.randint(0, 4)) for c in base)
    reads = sample_reads(rng, genome, 120, min_len=700, max_len=2000,
                         err=0.1, junk_frac=0.1)
    queries = reads[:30]
    cfg = OverlapConfig(index=IndexOpt(k=15, w=10, is_hpc=True),
                        map=MapOpt(min_score_med=80, min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    eng = DeviceOverlapEngine(cfg, queries)
    rows_dev = eng.run(list(reads))
    assert rows_dev == rows_host


def test_device2_wide_hash_k19_rows_match_host():
    """pb-hifi fast preset geometry (-k 19 -w 10, longQC.py:222-231):
    wide hashes ride i64 lanes through the device index, count pass
    and step; rows stay identical to the host spec."""
    rng = np.random.RandomState(11)
    genome = make_genome(rng, 30000)
    reads = sample_reads(rng, genome, 120, min_len=900, max_len=2600,
                         err=0.04, junk_frac=0.05)
    queries = reads[:40]
    cfg = OverlapConfig(index=IndexOpt(k=19, w=10),
                        map=MapOpt(min_score_med=80,
                                   min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    eng = DeviceOverlapEngine(cfg, queries)
    rows_dev = eng.run(list(reads))
    assert rows_dev == rows_host


def test_device2_wide_hash_multipart():
    rng = np.random.RandomState(41)
    genome = make_genome(rng, 24000)
    reads = sample_reads(rng, genome, 140, min_len=700, max_len=2000,
                         err=0.08, junk_frac=0.1)
    queries = reads[:24]
    cfg = OverlapConfig(index=IndexOpt(k=19, w=10, batch_size=60_000),
                        map=MapOpt(min_score_med=80,
                                   min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    eng = DeviceOverlapEngine(cfg, queries)
    rows_dev = eng.run(list(reads))
    assert rows_dev == rows_host
    assert eng.n_device_calls >= 2


def test_device2_host_only_part_boundary():
    """A part past the device-index ceiling must fall back to the exact
    host path for the WHOLE part — rows identical, event counted (the
    round-4 silent-scale-cliff gap: no published number ever crossed
    the ceiling)."""
    rng = np.random.RandomState(41)
    genome = make_genome(rng, 20000)
    reads = sample_reads(rng, genome, 90, min_len=600, max_len=1800,
                         err=0.12, junk_frac=0.1)
    queries = reads[:24]
    cfg = _cfg()
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    eng = DeviceOverlapEngine(cfg, queries)
    # shrink the canonical-width ladder so this part overflows it
    eng.n_idx_sizes = (1 << 10,)
    rows_dev = eng.run(list(reads))
    assert rows_dev == rows_host
    assert eng.n_host_only_parts == 1
    assert eng.n_host_fallback == len(queries)


def test_device2_sharded_index_rows_match_host():
    """Hash-range-sharded device index (parts past one canonical
    width): rows must stay identical to the host spec with the WHOLE
    part riding the device path (the round-4 gap: everything past
    ~24 Mbp silently fell to the host)."""
    rng = np.random.RandomState(53)
    genome = make_genome(rng, 40000)
    reads = sample_reads(rng, genome, 300, min_len=600, max_len=1800,
                         err=0.12, junk_frac=0.1)
    queries = reads[:32]
    cfg = _cfg()
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    eng = DeviceOverlapEngine(cfg, queries)
    # shrink the width ladder so this part needs the sharded layout
    eng.n_idx_sizes = (1 << 12, 1 << 14)
    rows_dev = eng.run(list(reads))
    assert rows_dev == rows_host
    assert eng.n_sharded_parts == 1
    assert eng.n_host_only_parts == 0
