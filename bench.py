"""Benchmark: overlap-sampling throughput vs the reference CPU binary.

Generates deterministic synthetic long-read datasets at two scales,
runs the device overlap-coverage engine on the GPU (the sampleqc hot path:
sketch -> index -> seed lookup -> chain DP -> coverage accounting),
times it, and compares with the reference minimap2-coverage binary on
the same input (compiled from the read-only reference checkout; rows
also cross-checked for bit-identity).

Scales (a scale curve that amortizes fixed costs, up to a 100+ Mbp
point on the device index):
  base   1,500 targets / 250 queries / 0.4 Mb genome  (r3 continuity)
  large  10,000 targets / 1,000 queries / 20 Mb genome
  xl     70,000 targets (~115 Mbp) / 1,000 queries — rides the
         hash-range-sharded device index end-to-end
The headline metric/vs_baseline is the LARGE point; per-scale details
land under RESULT["scales"].

Budget discipline (the round-2 bench timed out and published nothing —
never again): a watchdog thread prints the best-so-far JSON line and
exits the process at BENCH_BUDGET_S (default 480 s). Every section
updates the shared RESULT dict incrementally and is individually
try/except-guarded, so whatever has been measured by the deadline is
what gets published.

Methodology notes (recorded in the JSON):
- the reference runs with -t <all cores of this box>; BASELINE.md's
  north star denominator is a 16-core host, so `baseline_cores` states
  what was actually used.
- `warmup_s` is each scale's first full-workload pass (compile +
  execute); compiled programs land in the persistent compile cache
  and are reused across processes.
- host-fallback accounting (chain-kernel flags, exact-geometry flags)
  is reported per scale and for an adversarial repeat-rich /
  low-complexity set; the device path is only honest if these stay
  near zero.

Prints one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
and exits nonzero when JAX finds no GPU or any section failed.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

SCALES = {
    "base": dict(n_target=int(os.environ.get("BENCH_N_TARGET", "1500")),
                 n_query=int(os.environ.get("BENCH_N_QUERY", "250")),
                 genome=int(os.environ.get("BENCH_GENOME", "400000")),
                 seed=1234),
    "large": dict(n_target=int(os.environ.get("BENCH_N_TARGET_L", "10000")),
                  n_query=int(os.environ.get("BENCH_N_QUERY_L", "1000")),
                  genome=int(os.environ.get("BENCH_GENOME_L", "20000000")),
                  seed=4321),
}
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "480"))

REF_SRC = "/root/reference/minimap2-coverage"
BUILD_DIR = "/tmp/ref-mm2cov"

T0 = time.time()
RESULT = {
    "metric": "overlap-sampled target reads/s (1 chip, large scale)",
    "value": 0.0,
    "unit": "reads/s",
    "vs_baseline": 0.0,
    "scales": {},
}
_PRINTED = threading.Event()
_LOCK = threading.Lock()
FAILED = []          # names of sections that failed


def left():
    return BUDGET_S - (time.time() - T0)


def log(msg):
    print("bench[%5.1fs]: %s" % (time.time() - T0, msg), file=sys.stderr,
          flush=True)


def emit_and_exit(code=0):
    if FAILED:
        RESULT["failed_sections"] = list(FAILED)
        code = code or 1
    with _LOCK:
        if not _PRINTED.is_set():
            _PRINTED.set()
            print(json.dumps(RESULT), flush=True)
    os._exit(code)


def _watchdog():
    while True:
        r = left()
        if r <= 8.0:
            log("watchdog: budget reached, emitting best-so-far")
            FAILED.append("budget")
            emit_and_exit(1)
        time.sleep(min(r - 8.0, 5.0))


def build_reference():
    exe = os.path.join(BUILD_DIR, "minimap2-coverage")
    if os.path.exists(exe):
        return exe
    if not os.path.isdir(REF_SRC):
        return None
    try:
        shutil.copytree(REF_SRC, BUILD_DIR, dirs_exist_ok=True)
        r = subprocess.run(["make", "-j2"], cwd=BUILD_DIR,
                           capture_output=True, timeout=300)
        if r.returncode == 0 and os.path.exists(exe):
            return exe
    except Exception as e:
        log("reference build failed: %r" % (e,))
    return None


def run_engine(reads, queries, cfg):
    from longqc_tpu.engine.device_overlap import DeviceOverlapEngine

    eng = DeviceOverlapEngine(cfg, queries)
    rows = eng.run(list(reads))
    return rows, eng


def cache_dir():
    import jax
    return jax.config.jax_compilation_cache_dir or ""


def n_cache_entries():
    try:
        return len(os.listdir(cache_dir()))
    except OSError:
        return 0


def gen_data(spec):
    from util_synth import make_genome, sample_reads

    rng = np.random.RandomState(spec["seed"])
    genome = make_genome(rng, spec["genome"])
    reads = sample_reads(rng, genome, spec["n_target"], min_len=800,
                         max_len=2500, err=0.12, junk_frac=0.1)
    return reads, reads[:spec["n_query"]]


def run_reference(exe, reads, queries, tag, threads=None):
    from util_synth import write_fastq_file

    tmp = "/tmp/longqc_bench_%s" % tag
    os.makedirs(tmp, exist_ok=True)
    tfq = os.path.join(tmp, "target.fq")
    qfq = os.path.join(tmp, "query.fq")
    if not os.path.exists(tfq):
        write_fastq_file(tfq, reads)
        write_fastq_file(qfq, queries)
    ncpu = threads or os.cpu_count() or 1
    t0 = time.time()
    with open(os.path.join(tmp, "ref_out.txt"), "w") as fo:
        subprocess.run(
            [exe, "-Y", "-l", "0", "-q", "160", "-p", "80", "-k", "12",
             "-w", "5", "-t", str(ncpu), tfq, qfq],
            stdout=fo, stderr=subprocess.DEVNULL, check=True)
    wall = time.time() - t0
    with open(os.path.join(tmp, "ref_out.txt")) as f:
        rows = [ln.rstrip("\n") for ln in f if ln.strip()]
    return wall, rows


def reference_scaling_curve(exe, reads, queries, tag):
    """Measured reference wall at every thread count this box allows,
    plus a CLEARLY LABELED 16-core extrapolation (BASELINE.md's north
    star denominator is a 16-core host; this box has os.cpu_count()
    cores, so the 16-core number cannot be measured here). The
    extrapolation assumes ideal scaling of the parallel fraction
    observed between the largest two measured points (Amdahl fit) —
    an upper bound on the real 16-core throughput."""
    ncpu = os.cpu_count() or 1
    curve = {}
    for t in range(1, ncpu + 1):
        wall, _rows = run_reference(exe, reads, queries, tag, threads=t)
        curve[str(t)] = round(wall, 3)
        log("%s reference -t %d: %.2fs" % (tag, t, wall))
    out = {"measured_wall_s": curve, "cores_on_box": ncpu}
    if ncpu >= 2:
        w1 = curve["1"]
        wn = curve[str(ncpu)]
        # Amdahl: w(t) = serial + parallel/t fitted on (1, ncpu)
        par = (w1 - wn) * ncpu / (ncpu - 1)
        ser = max(w1 - par, 0.0)
        w16 = ser + par / 16.0
        out["extrapolated_16core_wall_s"] = round(w16, 3)
        out["extrapolation_note"] = (
            "Amdahl fit on the measured 1..%d-core walls; IDEAL-scaling "
            "upper bound, NOT a measurement (this box has %d cores)"
            % (ncpu, ncpu))
    return out


def live_path_util(reads, queries, cfg, n_rep=3):
    """Per-program device time of the live phases (sketch tile, index
    sort, mid_occ, count, step) on the large dataset: min over n_rep
    calls, each ended by block_until_ready."""
    import jax
    import jax.numpy as jnp
    from longqc_tpu.engine import device_index as di
    from longqc_tpu.engine import device_overlap as do

    def t(fn):
        best = None
        for _ in range(n_rep):
            t0 = time.time()
            jax.block_until_ready(fn())
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        return best

    out = {"note": "times are min-of-%d with explicit sync" % n_rep}
    k, w = cfg.index.k, cfg.index.w
    tiles, jumbo = di.pack_part_tiles(reads, w)
    tiles += jumbo
    tt = tiles[0]
    args = tuple(jnp.asarray(a) for a in (
        tt.codes2, tt.nmask, tt.startmask, tt.endmask, tt.starts,
        tt.gids, tt.used))
    jax.block_until_ready(args)
    dt_tile = t(lambda: di.tile_flat(
        *args, R=tt.R, W=tt.W, k=k, w=w, wide=2 * k > 30))
    out["sketch_tile"] = {"ms": round(dt_tile * 1e3, 1),
                          "bases": tt.R * tt.W}

    pidx = do._PartIndex(reads, k, w, cfg.map.mid_occ,
                         cfg.map.mid_occ_frac, di.TILE_LADDER,
                         di.N_IDX_SIZES)
    if not pidx.host_only and pidx.n_shards == 1:
        n_idx = pidx.ih.shape[0]
        dt_sort = t(lambda: di.sort_index(pidx.ih, pidx.irid,
                                          pidx.ips))
        out["index_sort"] = {"ms": round(dt_sort * 1e3, 1),
                             "n": int(n_idx)}
        dt_mo = t(lambda: di._mid_occ_device(
            pidx.ih, frac=cfg.map.mid_occ_frac))
        out["mid_occ"] = {"ms": round(dt_mo * 1e3, 1)}
        eng = do.DeviceOverlapEngine(cfg, queries)
        g = eng.groups[0]
        mcrop = g.count_crop()
        dt_cnt = t(lambda: do._count_expanded(
            pidx.ih, g.qh, g.qcnt, g.n_slots, pidx.mid_occ,
            mcrop=mcrop))
        out["count_seed_search"] = {
            "ms": round(dt_cnt * 1e3, 1),
            "queries": int(2 * g.qh.shape[0] * mcrop),
            "mcrop": int(mcrop), "M": int(g.qh.shape[1])}
        cnt, lft, occ = do._count_expanded(pidx.ih, g.qh, g.qcnt,
                                           g.n_slots, pidx.mid_occ)
        nq = np.asarray(cnt)
        rung = next((a for a in eng.a_ladder
                     if a >= int(nq[:len(g.qids)].max())),
                    eng.a_ladder[-1])
        qrank = np.full(eng.lanes, -1, np.int32)
        for r_, qi in enumerate(g.qids):
            qrank[r_] = pidx.name_rank.get(queries[qi][0], -1)
        qrank_d = jnp.asarray(qrank)
        qbis_d = jnp.asarray(np.zeros(eng.lanes, np.int32))
        st = eng._static(g, rung)

        def _step_once():
            lam = jnp.zeros((eng.lanes,), jnp.int64)
            lam2 = jnp.zeros((eng.lanes,), jnp.int64)
            avgk = jnp.zeros((eng.lanes,), jnp.int32)
            mc = jnp.zeros((eng.lanes, g.M2), jnp.int32)
            return do._step(
                pidx.irid, pidx.ips, pidx.seq_lens, pidx.rid_rank,
                pidx.mid_occ, lft, occ, g.qps, g.qcnt, g.n_slots,
                g.n_exp, g.qlen, qrank_d, qbis_d, g.qvalid,
                lam, lam2, avgk, mc, eng.limbs5, st=st)

        dt_step = t(_step_once)
        out["step"] = {"ms": round(dt_step * 1e3, 1), "A_rung": int(rung),
                       "chain": st.chain}
    return out


def bench_scale(name, reads, queries, cfg, exe, n_timed=2,
                ref_curve=True):
    from util_synth import write_fastq_file  # noqa: F401  (env parity)

    S = {"n_target": len(reads), "n_query": len(queries),
         "mbp": round(sum(len(r[1]) for r in reads) / 1e6, 1)}
    RESULT["scales"][name] = S
    ref_rows = None
    if exe is not None:
        ncpu = os.cpu_count() or 1
        curve = {}
        if ref_curve:
            curve = reference_scaling_curve(exe, reads, queries, name)
            S["ref_scaling"] = curve
        ref_wall, ref_rows = run_reference(exe, reads, queries, name)
        S["ref_wall_s"] = round(ref_wall, 3)
        S["ref_reads_per_s"] = round(len(reads) / ref_wall, 1)
        if "extrapolated_16core_wall_s" in curve:
            S["ref_reads_per_s_16core_extrapolated"] = round(
                len(reads) / curve["extrapolated_16core_wall_s"], 1)
        log("%s reference: %.2fs (%.0f reads/s at -t %d)"
            % (name, ref_wall, len(reads) / ref_wall, ncpu))

    cache_before = n_cache_entries()
    t0 = time.time()
    rows, eng = run_engine(reads, queries, cfg)
    S["warmup_s"] = round(time.time() - t0, 1)
    S["cache_misses"] = n_cache_entries() - cache_before
    log("%s warm-up: %.1fs (%d new cache entries)"
        % (name, S["warmup_s"], S["cache_misses"]))

    if ref_rows is not None:
        mism = sum(1 for a, b in zip(rows, ref_rows) if a != b)
        mism += abs(len(rows) - len(ref_rows))
        S["rows_identical_to_reference"] = (mism == 0)
        if mism:
            log("%s WARNING: %d/%d rows differ from reference"
                % (name, mism, len(rows)))

    best = None
    for i in range(n_timed):
        if left() < 20:
            break
        t0 = time.time()
        _, eng = run_engine(reads, queries, cfg)
        wall = time.time() - t0
        if best is None or wall < best:
            best = wall
            S["device_wall_s"] = round(wall, 3)
            S["reads_per_s"] = round(len(reads) / wall, 1)
            S["phase_s"] = {k: round(v, 3) for k, v in
                            sorted(eng.phase_s.items())}
            S["host_fallback_rows"] = eng.n_host_fallback
            S["host_only_parts"] = eng.n_host_only_parts
            S["sharded_parts"] = eng.n_sharded_parts
            S["flag_counts"] = {str(k): v for k, v in
                                sorted(eng.flag_counts.items())}
            S["device_calls"] = eng.n_device_calls
            if "ref_wall_s" in S:
                S["vs_baseline"] = round(wall and (len(reads) / wall) /
                                         (len(reads) / S["ref_wall_s"]), 3)
            if "ref_reads_per_s_16core_extrapolated" in S:
                S["vs_baseline_16core_extrapolated"] = round(
                    S["reads_per_s"] /
                    S["ref_reads_per_s_16core_extrapolated"], 3)
        log("%s timed %d: %.2fs (%.0f reads/s)"
            % (name, i, wall, len(reads) / wall))
    return S


def main():
    threading.Thread(target=_watchdog, daemon=True).start()
    if os.environ.get("BENCH_STACK_DUMPS"):
        import faulthandler
        faulthandler.dump_traceback_later(
            int(os.environ["BENCH_STACK_DUMPS"]), repeat=True,
            file=sys.stderr)

    import jax
    dev = jax.devices()
    if dev[0].platform != "gpu":
        log("no GPU: JAX's first device is %r" % (dev[0],))
        RESULT["error"] = "no GPU"
        emit_and_exit(2)
    RESULT["device"] = {"platform": dev[0].platform,
                        "kind": dev[0].device_kind, "count": len(dev)}
    log("device: %s" % RESULT["device"])
    from longqc_tpu.config import OverlapConfig, IndexOpt, MapOpt, FltOpt
    cfg = OverlapConfig(
        index=IndexOpt(k=12, w=5),
        map=MapOpt(min_score_med=80, min_score_good=160),
        flt=FltOpt(min_ovlp=0))

    # generate the large dataset on a side thread while the base scale
    # runs (pure numpy, ~55 s)
    large_box = {}

    def gen_large():
        try:
            large_box["data"] = gen_data(SCALES["large"])
        except Exception as e:
            large_box["err"] = e

    th = threading.Thread(target=gen_large, daemon=True)
    th.start()

    log("generating base dataset...")
    reads_b, queries_b = gen_data(SCALES["base"])
    ncpu = os.cpu_count() or 1
    RESULT["baseline_cores"] = ncpu
    RESULT["baseline_note"] = (
        "reference measured at every -t in 1..%d on this box (see "
        "scales.*.ref_scaling); the 16-core BASELINE.md denominator is "
        "published as a clearly-labeled Amdahl extrapolation "
        "(vs_baseline_16core_extrapolated), not a measurement" % ncpu)
    exe = build_reference()

    # the datagen thread competes for the 2 host cores: make sure it
    # has drained before any timed engine pass
    th.join(timeout=max(left() - 150, 5))
    try:
        bench_scale("base", reads_b, queries_b, cfg, exe)
    except Exception as e:
        log("base scale failed: %r" % (e,))
        FAILED.append("base scale")
        RESULT["scales"].setdefault("base", {})["error"] = repr(e)
    if "data" in large_box:
        try:
            reads_l, queries_l = large_box["data"]
            S = bench_scale("large", reads_l, queries_l, cfg, exe)
            if "reads_per_s" in S:
                RESULT["value"] = S["reads_per_s"]
                RESULT["device_wall_s"] = S["device_wall_s"]
                RESULT["vs_baseline"] = S.get("vs_baseline", 0.0)
                if "vs_baseline_16core_extrapolated" in S:
                    RESULT["vs_baseline_16core_extrapolated"] = \
                        S["vs_baseline_16core_extrapolated"]
                RESULT["metric"] = (
                    "overlap-sampled target reads/s (1 chip, %d targets "
                    "%.1f Mbp vs %d sampled reads)"
                    % (S["n_target"], S["mbp"], S["n_query"]))
            del reads_l, queries_l
        except Exception as e:
            log("large scale failed: %r" % (e,))
            FAILED.append("large scale")
            RESULT["scales"].setdefault("large", {})["error"] = repr(e)
    else:
        log("large dataset generation failed/timed out: %r"
            % (large_box.get("err"),))
        FAILED.append("large data")
    # fall back to the base scale as headline if large produced nothing
    if RESULT["value"] == 0.0 and \
            "reads_per_s" in RESULT["scales"].get("base", {}):
        B = RESULT["scales"]["base"]
        RESULT["value"] = B["reads_per_s"]
        RESULT["device_wall_s"] = B["device_wall_s"]
        RESULT["vs_baseline"] = B.get("vs_baseline", 0.0)
        RESULT["metric"] = (
            "overlap-sampled target reads/s (1 chip, base scale)")

    # ---- xl scale: 100+ Mbp target set riding the hash-range-sharded
    # device index end-to-end (rows checked against the
    # reference binary like every scale) ----
    try:
        if left() > 170:
            from util_synth import make_genome_fast, sample_reads_fast
            rng3 = np.random.RandomState(777)
            g3 = make_genome_fast(rng3, 20000000)
            reads_x = sample_reads_fast(
                rng3, g3, int(os.environ.get("BENCH_N_TARGET_XL",
                                             "70000")),
                min_len=800, max_len=2500, err=0.12, junk_frac=0.1)
            log("xl dataset: %d reads / %.1f Mbp"
                % (len(reads_x), sum(len(r[1]) for r in reads_x) / 1e6))
            bench_scale("xl", reads_x, reads_x[:1000], cfg, exe,
                        n_timed=1, ref_curve=False)
            del reads_x
    except Exception as e:
        log("xl scale failed: %r" % (e,))
        FAILED.append("xl scale")
        RESULT["scales"].setdefault("xl", {})["error"] = repr(e)

    # ---- live-path per-program times ----
    try:
        if left() > 120 and "data" in large_box:
            RESULT["util"] = live_path_util(*large_box["data"], cfg)
            log("util: %s" % json.dumps(RESULT["util"]))
    except Exception as e:
        log("util probe failed: %r" % (e,))
        FAILED.append("util probe")

    # ---- adversarial fallback probe ----
    try:
        if left() > 100:
            from util_synth import make_genome, sample_reads
            rng2 = np.random.RandomState(77)
            core = make_genome(rng2, 2500)
            adv_genome = core * 8 + "AT" * 3000 + make_genome(rng2, 5000)
            adv_reads = sample_reads(rng2, adv_genome, 300, min_len=600,
                                     max_len=1800, err=0.08, junk_frac=0.05)
            _, adv_eng = run_engine(adv_reads, adv_reads[:64], cfg)
            RESULT["adversarial_fallback_frac"] = round(
                adv_eng.n_host_fallback / 64.0, 4)
            RESULT["adversarial_flag_counts"] = {
                str(k): v for k, v in sorted(adv_eng.flag_counts.items())}
            log("adversarial fallback frac: %.3f flags=%s"
                % (RESULT["adversarial_fallback_frac"],
                   RESULT["adversarial_flag_counts"]))
    except Exception as e:
        log("adversarial probe failed: %r" % (e,))
        FAILED.append("adversarial probe")

    emit_and_exit(0)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:
        log("FATAL: %r" % (e,))
        RESULT["error"] = repr(e)
        emit_and_exit(1)
