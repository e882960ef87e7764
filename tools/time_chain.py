#!/usr/bin/env python3
"""Time the two chain routes on the GPU: the CUDA ring kernels against
their plain lax.scan forms, (1) in one step program at Q = 128, J = 64
and A in {1024, 4096, 16384}, and (2) end to end through the sampleqc
main path of chip_smoke.py (phase 4's synthetic ONT run: one warm-up
run per route, then one timed run each).

    python3 tools/time_chain.py [--step-reps 5] [--no-main]

Step runs alternate the routes (cuda, scan, scan, cuda) so drift on the
card shows; every time ends in block_until_ready. Prints one JSON line with
the medians.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

ORDER = ("cuda", "scan", "scan", "cuda")


def step_times(reps):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from util_synth import make_genome_fast, sample_reads_fast
    from longqc_tpu import config as C
    from longqc_tpu.engine import device_overlap as do

    rng = np.random.RandomState(3)
    genome = make_genome_fast(rng, 2_000_000)
    reads = sample_reads_fast(rng, genome, 3000, min_len=800,
                              max_len=3000, err=0.1, junk_frac=0.1)
    queries = reads[:128]
    cfg = C.overlap_config_for_sample(C.PRESETS["ont-ligation"])
    eng = do.DeviceOverlapEngine(cfg, queries)
    pidx = do._PartIndex(reads, eng.k, eng.w, cfg.map.mid_occ,
                         cfg.map.mid_occ_frac, eng.tile_ladder,
                         eng.n_idx_sizes)
    g = eng.groups[0]
    _cnt, left, occ = do._count_expanded(pidx.ih, g.qh, g.qcnt, g.n_slots,
                                         pidx.mid_occ)
    qrank = np.full(eng.lanes, -1, np.int32)
    for r, qi in enumerate(g.qids):
        qrank[r] = pidx.name_rank.get(queries[qi][0], -1)
    qrank = jnp.asarray(qrank)
    qbis = jnp.zeros(eng.lanes, jnp.int32)

    def run(st):
        return do._step(
            pidx.irid, pidx.ips, pidx.seq_lens, pidx.rid_rank,
            pidx.mid_occ, left, occ, g.qps, g.qcnt, g.n_slots, g.n_exp,
            g.qlen, qrank, qbis, g.qvalid,
            jnp.zeros(eng.lanes, jnp.int64), jnp.zeros(eng.lanes, jnp.int64),
            jnp.zeros(eng.lanes, jnp.int32),
            jnp.zeros((eng.lanes, g.M2), jnp.int32), eng.limbs5, st=st)

    out = {}
    for A in (1024, 4096, 16384):
        sts = {c: do._make_static(cfg, eng.lanes, g.M, g.M2, A, eng.k, c)
               for c in ("cuda", "scan")}
        res = {}
        for c, st in sts.items():
            t0 = time.time()
            res[c] = [np.asarray(x) for x in jax.block_until_ready(run(st))]
            out.setdefault("compile_and_first_s", {})["%s_A%d" % (c, A)] = \
                round(time.time() - t0, 3)
        same = all(np.array_equal(a, b)
                   for a, b in zip(res["cuda"], res["scan"]))
        times = {"cuda": [], "scan": []}
        for c in ORDER * reps:
            t0 = time.perf_counter()
            jax.block_until_ready(run(sts[c]))
            times[c].append(time.perf_counter() - t0)
        out["A%d" % A] = {
            "cuda_ms": statistics.median(times["cuda"]) * 1e3,
            "scan_ms": statistics.median(times["scan"]) * 1e3,
            "cuda_ms_all": [t * 1e3 for t in times["cuda"]],
            "scan_ms_all": [t * 1e3 for t in times["scan"]],
            "outputs_identical": same}
        print("step A=%d: cuda %.3f ms, scan %.3f ms (median of %d), "
              "identical=%s" % (A, out["A%d" % A]["cuda_ms"],
                                out["A%d" % A]["scan_ms"],
                                len(times["cuda"]), same), flush=True)
    return out


def main_path_times():
    import chip_smoke as cs
    from longqc_tpu import backend
    from longqc_tpu.cli import main as cli_main

    work = os.path.join(ROOT, "chiprun_out", "time_chain")
    os.makedirs(work, exist_ok=True)
    fq = os.path.join(work, "ont.fastq")
    bases, planted = cs.make_ont_fastq(fq)
    walls = {"cuda": [], "scan": []}
    for i, c in enumerate(("scan", "cuda", "scan", "cuda")):
        out = os.path.join(work, "out_%d_%s" % (i, c))
        with backend.use(chain=c):
            t0 = time.time()
            rc = cli_main(["sampleqc", "-x", "ont-ligation", "-o", out, fq])
            wall = time.time() - t0
        assert rc in (0, None), rc
        cs.check_outputs(out, bases, planted)
        shutil.rmtree(out)
        tag = "warm-up" if i < 2 else "timed"
        if i >= 2:
            walls[c].append(wall)
        print("main path %s %s: %.2fs" % (c, tag, wall), flush=True)
    os.remove(fq)
    return {"cuda_s": statistics.median(walls["cuda"]),
            "scan_s": statistics.median(walls["scan"]),
            "cuda_s_all": walls["cuda"], "scan_s_all": walls["scan"],
            "reads": cs.N_READS, "mbp": bases / 1e6}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step-reps", type=int, default=5)
    ap.add_argument("--no-main", action="store_true")
    args = ap.parse_args()
    import longqc_tpu  # noqa: F401
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit("no GPU: JAX's first device is %r" % (d,))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = {"device": d.device_kind, "nvidia_smi": smi,
           "step": step_times(args.step_reps)}
    if not args.no_main:
        res["main_path"] = main_path_times()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
