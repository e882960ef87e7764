#!/usr/bin/env python3
"""Smoke test of longqc_tpu on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases (each must pass; any failure exits nonzero with no result line):
  1. device: a GPU must be JAX's first device; prints its kind, count,
     name and power limit, the JAX version and the compile cache.
  2. kernels: the CUDA chain-DP fill and peak / min-rank ring passes at
     Q = 128, J = 64/128/256, A = 4096, bit-identical to their plain
     lax.scan forms on the card; memory analysis of one step program.
  3. engine: DeviceOverlapEngine on the production geometry, rows
     identical to the host spec overlap_host.overlap_run.
  4. main path: `sampleqc -x ont-ligation` through cli.main on a
     synthetic ONT FASTQ, every output checked.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 1


def phase_device(jax):
    dev = jax.devices()
    if dev[0].platform != "gpu":
        raise SystemExit("no GPU: JAX's first device is %r" % (dev[0],))
    log("device_kind: %s  count: %d" % (dev[0].device_kind, len(dev)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log("nvidia-smi: %s" % smi.stdout.strip().splitlines()[0])
    log("jax %s" % jax.__version__)
    log("compile cache: %s" % jax.config.jax_compilation_cache_dir)


# ---------------------------------------------------------------------------
# phase 2


def _anchor_rows(rng, Q, A, dense):
    """Random (Q, A) anchor rows with chain structure: sorted target
    positions in a few (rid, strand) groups along clustered diagonals;
    `dense` packs >64 anchors into max_dist so the J = 64 ring
    truncates (the escalation regime)."""
    import numpy as np
    axh = np.zeros((Q, A), np.int32)
    axl = np.zeros((Q, A), np.int32)
    aq = np.zeros((Q, A), np.int32)
    asp = np.full((Q, A), 12, np.int32)
    nb = np.zeros(Q, np.int32)
    for r in range(Q):
        n = rng.randint(A // 4, A + 1)
        nb[r] = n
        if dense:
            pos = np.sort(rng.randint(0, 4 * n, n))
            q = rng.randint(0, 40 * n, n)
            d = rng.rand(n) < 0.2
            q[d] = np.clip(pos[d] + rng.randint(-50, 50, d.sum()), 0, None)
        else:
            axh[r, :n] = np.sort(rng.randint(0, 4, n))
            pos = np.sort(rng.randint(0, 400 * n, n))
            diag = rng.randint(0, 3, n) * rng.randint(1, 400)
            q = np.clip(pos - 5000 + diag + rng.randint(-40, 40, n), 0,
                        None)
        axl[r, :n] = pos
        aq[r, :n] = q
    return axh, axl, aq, asp, nb


def phase_kernels(jax):
    import numpy as np
    from longqc_tpu.ops import chain_cuda
    from longqc_tpu.ops import chain_ring as cr

    t0 = time.time()
    chain_cuda.register()
    log("chain_ring library: %s (built/loaded in %.1fs)"
        % (chain_cuda.LIB, time.time() - t0))
    Q, A, bw = 128, 4096, 500
    rng = np.random.RandomState(1)
    limbs = np.repeat(cr.penalty_limbs(12.0, bw)[:, None], Q, axis=1)
    rbad = np.zeros(Q, np.int32)
    for J in cr.RING_DEPTHS:
        for dense in (False, True):
            axh, axl, aq, asp, nb = _anchor_rows(rng, Q, A, dense)
            outs = {}
            for impl in ("cuda", "scan"):
                fo = cr.chain_fill(
                    axh, axl, aq, asp, nb, limbs, rbad,
                    cr.make_ring_carry(Q, J), 0, J=J, max_dist=10000,
                    bw=bw, max_skip=25, impl=impl)
                f, p, v = fo[:3]
                pk = cr.peak_pass(f, v, p, J=J, impl=impl)
                own = np.where(np.asarray(f) > 40,
                               np.arange(A, dtype=np.int32)[None, :] % 97,
                               cr.INF32).astype(np.int32)
                mr = cr.minrank_pass(p, own, J=J, impl=impl)
                outs[impl] = [np.asarray(x) for x in fo] + \
                    [np.asarray(pk), np.asarray(mr)]
            names = ["f", "p", "v", "c_xh", "c_xl", "c_q", "c_s", "c_f",
                     "c_v", "c_p", "flags", "peak", "minrank"]
            for n, a, b in zip(names, outs["cuda"], outs["scan"]):
                if a.shape != b.shape or not np.array_equal(a, b):
                    raise AssertionError(
                        "J=%d dense=%s: %s differs (%d of %d)"
                        % (J, dense, n, int((a != b).sum()), a.size))
            log("kernels J=%d %s: fill/peak/minrank bit-identical "
                "(flagged rows %d of %d)"
                % (J, "dense" if dense else "chains",
                   int((outs["cuda"][10] != 0).sum()), Q))
    step_memory(jax)


def step_memory(jax):
    """Compile one step program at the production A rung (the 8192 rung
    holds a 4096-bucket group's typical rows) and print its memory
    analysis."""
    import jax.numpy as jnp
    from longqc_tpu import backend
    from longqc_tpu import config as C
    from longqc_tpu.engine import device_index as di
    from longqc_tpu.engine import device_overlap as do

    cfg = C.overlap_config_for_sample(C.PRESETS["ont-ligation"])
    be = backend.decide()
    lanes, blen, A = do.GROUP_Q, 4096, 8192
    M, M2 = blen // 2, blen
    n_idx, Bp = di.N_IDX_SIZES[0], do.B_PADS[0]
    st = do._make_static(cfg, lanes, M, M2, A, cfg.index.k, be.chain)

    def sds(shape, dtype=jnp.int32):
        return jax.ShapeDtypeStruct(shape, dtype)

    t0 = time.time()
    lowered = do._step.lower(
        sds((n_idx,)), sds((n_idx,)), sds((Bp,)), sds((Bp,)), sds(()),
        sds((lanes, M)), sds((lanes, M)), sds((lanes, M)),
        sds((lanes, M)), sds((lanes,)), sds((lanes,)), sds((lanes,)),
        sds((lanes,)), sds((lanes,)), sds((lanes,)),
        sds((lanes,), jnp.int64), sds((lanes,), jnp.int64),
        sds((lanes,)), sds((lanes, M2)), sds((5,)), st=st)
    compiled = lowered.compile()
    log("step program (Q=%d, M=%d, A=%d, index %d, chain=%s) compiled in "
        "%.1fs; memory_analysis: %s"
        % (lanes, M, A, n_idx, st.chain, time.time() - t0,
           compiled.memory_analysis()))


# ---------------------------------------------------------------------------
# phase 3


def phase_engine(jax):
    import numpy as np
    from util_synth import make_genome_fast, sample_reads_fast
    from longqc_tpu import backend
    from longqc_tpu import config as C
    from longqc_tpu.engine import overlap_host as oh
    from longqc_tpu.engine.device_overlap import DeviceOverlapEngine

    rng = np.random.RandomState(3)
    genome = make_genome_fast(rng, 2_000_000)
    reads = sample_reads_fast(rng, genome, 3000, min_len=800,
                              max_len=3000, err=0.1, junk_frac=0.1)
    queries = reads[:160]          # one full 128-lane group + a partial
    cfg = C.overlap_config_for_sample(C.PRESETS["ont-ligation"])
    eng = DeviceOverlapEngine(cfg, queries)
    assert backend.decide().geometry == "big" and eng.chain == "cuda"
    t0 = time.time()
    rows_dev = eng.run(iter(reads))
    t_dev = time.time() - t0
    t0 = time.time()
    rows_host = oh.overlap_run(iter(reads), queries, cfg)
    t_host = time.time() - t0
    if rows_dev != rows_host:
        bad = sum(a != b for a, b in zip(rows_dev, rows_host))
        raise AssertionError("engine rows differ from overlap_host on "
                             "%d of %d queries" % (bad, len(queries)))
    log("engine: %d queries x %d targets, rows identical to "
        "overlap_host.overlap_run; host-fallback rows %d; device "
        "calls %d; engine %.1fs (cold), host spec %.1fs"
        % (len(queries), len(reads), eng.n_host_fallback,
           eng.n_device_calls, t_dev, t_host))


# ---------------------------------------------------------------------------
# phase 4

N_READS = 20000
GENOME = 10_000_000
N_SAMPLE = 5000


def make_ont_fastq(path, seed=7):
    """Synthetic ONT run: lognormal lengths (median 3 kb, clipped to
    500-50,000 bp), 10% error, 10% junk reads, the ont-ligation 5'
    adapter planted on 30% of reads. Returns (bases, planted)."""
    import numpy as np
    from util_synth import (make_genome_fast, sample_reads_fast,
                            write_fastq_file)
    from longqc_tpu import config as C

    rng = np.random.RandomState(seed)
    genome = make_genome_fast(rng, GENOME)
    lengths = np.clip(np.round(rng.lognormal(np.log(3000), 0.5, N_READS)),
                      500, 50000)
    reads = sample_reads_fast(rng, genome, N_READS, lengths=lengths,
                              err=0.1, junk_frac=0.1)
    adp = C.PRESETS["ont-ligation"].adp5
    planted = rng.random_sample(N_READS) < 0.3
    for r, p in zip(reads, planted):
        if p:
            r[1] = adp + r[1]
            r[2] = "I" * len(adp) + r[2]
    write_fastq_file(path, reads)
    return sum(len(r[1]) for r in reads), int(planted.sum())


def _fallback_rows(out_dir):
    import re
    logp = os.path.join(out_dir, "logs", "log_longQC_sampleqc.txt")
    with open(logp) as fh:
        text = fh.read()
    hits = re.findall(r"device overlap: (\d+) rows, \d+ device calls, "
                      r"(\d+) host-fixed rows", text)
    assert hits, "no device overlap record in " + logp
    for ln in text.splitlines():
        if "device overlap:" in ln or "chunk stages:" in ln:
            log("  log: " + ln.split(":INFO:")[-1])
    return sum(int(h[0]) for h in hits), sum(int(h[1]) for h in hits)


def check_outputs(out_dir, bases, planted):
    import json
    with open(os.path.join(out_dir, "QC_vals_longQC_sampleqc.json")) as fh:
        qc = json.load(fh)
    assert qc["Yield"] == bases, (qc["Yield"], bases)
    assert qc["Num_of_reads"] == N_READS, qc["Num_of_reads"]
    with open(os.path.join(out_dir, "analysis", "minimap2",
                           "coverage_out.txt")) as fh:
        cov = [ln.split("\t") for ln in fh.read().splitlines() if ln]
    assert len(cov) == N_SAMPLE and all(len(c) == 9 for c in cov), \
        (len(cov), {len(c) for c in cov})
    with open(os.path.join(out_dir, "analysis", "longqc_sdust.txt")) as fh:
        sd = [ln.split("\t") for ln in fh.read().splitlines() if ln]
    assert len(sd) == N_READS and all(len(c) == 6 for c in sd), \
        (len(sd), {len(c) for c in sd})
    with open(os.path.join(out_dir, "web_summary.html")) as fh:
        n_png = fh.read().count("data:image/png")
    assert n_png == 8, n_png
    n_trim = qc["Stats_for_adapter5"]["Num_of_trimmed_reads_5"]
    assert abs(n_trim - planted) <= 0.01 * planted, (n_trim, planted)
    return qc, n_trim


def phase_main(jax):
    from longqc_tpu.cli import main as cli_main
    from longqc_tpu.io import native

    import shutil
    work = os.path.join(ROOT, "chiprun_out", "smoke")
    if os.path.exists(work):
        shutil.rmtree(work)
    os.makedirs(work)
    fq = os.path.join(work, "ont.fastq")
    t0 = time.time()
    bases, planted = make_ont_fastq(fq)
    log("main path input: %d reads, %.2f Mbp, %d with the 5' adapter "
        "(made in %.1fs; size not cut)"
        % (N_READS, bases / 1e6, planted, time.time() - t0))
    log("fastq reader: %s" % ("native C++" if native.available()
                              else "pure Python"))
    for tag in ("cold", "warm"):
        out = os.path.join(work, "out_" + tag)
        t0 = time.time()
        rc = cli_main(["sampleqc", "-x", "ont-ligation", "-o", out, fq])
        wall = time.time() - t0
        assert rc in (0, None), rc
        qc, n_trim = check_outputs(out, bases, planted)
        n_rows, n_fb = _fallback_rows(out)
        log("main path %s: %.1fs wall; %d reads, %.2f Mbp; adapters "
            "trimmed %d of %d planted; coverage rows %d; host-fallback "
            "rows %d (%.3f%% of the sample); mean coverage %s"
            % (tag, wall, qc["Num_of_reads"], qc["Yield"] / 1e6, n_trim,
               planted, n_rows, n_fb, 100.0 * n_fb / N_SAMPLE,
               qc.get("Coverage_stats", {}).get("Mean_coverage")))
        assert n_fb <= 0.01 * N_SAMPLE, n_fb
        shutil.copy(os.path.join(out, "logs", "log_longQC_sampleqc.txt"),
                    os.path.join(work, "log_%s.txt" % tag))
        shutil.rmtree(out)
    os.remove(fq)


PHASES = {"1": phase_device, "2": phase_kernels, "3": phase_engine,
          "4": phase_main}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="".join(sorted(PHASES)),
                    help="phases to run (default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import longqc_tpu  # noqa: F401  (x64 + compile cache setup)
    import jax

    phase_device(jax)
    for ph in args.phases:
        if ph == "1":
            continue
        t0 = time.time()
        PHASES[ph](jax)
        log("phase %s: %.1fs" % (ph, time.time() - t0))
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
