"""End-to-end overlap rows on the plain chain route: the batched
chainer (ops/chain) and the device engine (ops/chain_ring's scan forms
on this backend) must both equal the host spec exactly."""

import numpy as np

from longqc_tpu.config import OverlapConfig, IndexOpt, MapOpt, FltOpt
from longqc_tpu.engine import overlap_host as oh
from longqc_tpu.engine.device_overlap import DeviceOverlapEngine
from longqc_tpu.engine.overlap import DeviceChainer
from util_synth import make_genome, sample_reads


def test_chainer_and_engine_rows_match_host():
    rng = np.random.RandomState(11)
    genome = make_genome(rng, 30000)
    reads = sample_reads(rng, genome, 150, min_len=700, max_len=2200,
                         err=0.12, junk_frac=0.1)
    queries = reads[:40]
    cfg = OverlapConfig(index=IndexOpt(k=12, w=5),
                        map=MapOpt(min_score_med=80, min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    chainer = DeviceChainer()
    rows_ch = oh.overlap_run(list(reads), queries, cfg,
                             chain_many=chainer)
    assert rows_ch == rows_host
    assert chainer.n_device > 0
    eng = DeviceOverlapEngine(cfg, queries)
    assert eng.chain == "scan"
    assert eng.run(list(reads)) == rows_host
