"""sampleqc pipeline orchestration (command_sample equivalent).

Reproduces the reference's sampleqc flow (longQC.py:66-865): chunked
streaming of the input with per-chunk masking / adapter search /
reservoir subsampling / GC accumulation, exclusion of highly-masked
reads from the sample, the all-vs-sample overlap run, the PacBio
spike-in-control filter run, coverage analytics, and JSON + plots +
HTML outputs. Stages that were subprocesses in the reference
(sdust, minimap2-coverage) are in-process device programs here.

Known divergence from the reference: its adapter trimming mutates reads
inside a pickled pool-worker copy, so the main-process stream (and the
-c trim output) is effectively untrimmed; here -c writes genuinely
trimmed copies while the analysis stream stays untrimmed to match the
reference's downstream inputs.
"""

import copy
import json
import logging
import os
import sys
from collections import OrderedDict

import numpy as np

from longqc_tpu import config as C
from longqc_tpu._version import __version__
from longqc_tpu.engine.masking import MaskAccumulator
from longqc_tpu.engine.overlap import overlap_run_device as overlap_run
from longqc_tpu.io.fastx import (guess_format, open_seq_chunk, iter_fastx,
                                 write_fastq, FORMAT_BAM, FORMAT_SAM,
                                 FORMAT_FASTA, FORMAT_FAST5, FORMAT_UNKNOWN)
from longqc_tpu.io.sampling import subsample_from_chunk
from longqc_tpu.io.stats import get_N50
from longqc_tpu.ops.adapter import cut_adapter
from longqc_tpu.ops.distfit import estimate_gamma_dist
from longqc_tpu.ops.gc import GCAccumulator
from longqc_tpu.report import plots
from longqc_tpu.report.coverage import CoverageAnalytics
from longqc_tpu.report.html import render_report, enc_b64_str

logger = logging.getLogger(__name__)

CONTROL_REFS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "refs")


def _control_ref_path(sequel):
    name = ("Sequel_control_reference.fasta" if sequel
            else "RS2_control_reference.fasta")
    return os.path.abspath(os.path.join(CONTROL_REFS_DIR, name))


def run_sampleqc(input_path, out_dir, preset_name, *, nsample=5000,
                 transcript=False, suffix=None, trim_out=None,
                 adp5=None, adp3=None, fast=False, mem=0.5,
                 index_size="4G", short=False, n_devices=None,
                 db=False, ncpu=4, force_pb=None, force_sequel=None,
                 force_ont=None):
    """Run sample QC. Returns the JSON dict of QC values.

    db: the -d/--db flag (longQC.py:266-277) — prefetch the target read
    stream and build/persist the overlap index (npz parts under
    analysis/minimap2/) concurrently with the chunk-QC loop, so the
    overlap stage starts with parts ready.
    ncpu: advisory host-thread budget (-p; the reference spends these on
    subprocess pools — here stages are in-process device programs, so
    only host-side I/O pools consult it).
    force_pb/force_sequel/force_ont: the hidden expert flags
    (longQC.py:942-947) overriding the preset's platform markers.
    """
    if not os.path.exists(input_path):
        raise FileNotFoundError(input_path)
    if not 0 < nsample <= C.MAX_N_SAMPLE:
        raise ValueError("n_sample out of range")
    if os.path.exists(out_dir):
        raise FileExistsError("output path %s already exists" % out_dir)

    preset = C.PRESETS[preset_name]
    if force_pb or force_sequel:
        # reference semantics: the preset table only SETS these markers
        # (longQC.py:174-214), so expert flags are additive; --ont has
        # no live effect in the reference either (":474" is commented)
        import dataclasses
        preset = dataclasses.replace(
            preset, pb=preset.pb or bool(force_pb),
            sequel=preset.sequel or bool(force_sequel))
    adp5 = adp5 or preset.adp5
    adp3 = adp3 or preset.adp3
    sfx = ("_" + suffix) if suffix else ""

    analysis_dir = os.path.join(out_dir, "analysis")
    mm2_dir = os.path.join(analysis_dir, "minimap2")
    figs = os.path.join(out_dir, "figs")
    logs = os.path.join(out_dir, "logs")
    for d in (mm2_dir, figs, logs):
        os.makedirs(d, exist_ok=True)

    fh = logging.FileHandler(
        os.path.join(logs, "log_longQC_sampleqc%s.txt" % sfx), "w")
    fh.setFormatter(logging.Formatter(
        "%(module)s:%(asctime)s:%(lineno)d:%(levelname)s:%(message)s"))
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    root.addHandler(fh)

    cov_path = os.path.join(mm2_dir, "coverage_out%s.txt" % sfx)
    sample_path = os.path.join(analysis_dir, "subsample%s.fastq" % sfx)
    json_path = os.path.join(out_dir, "QC_vals_longQC_sampleqc%s.json" % sfx)
    html_path = os.path.join(out_dir, "web_summary%s.html" % sfx)

    def figp(tag):
        return os.path.join(figs, "fig_longQC_sampleqc_%s%s.png" % (tag, sfx))

    nonsense_err = C.NONSENSE_READ_ERROR_THRESHOLD
    nonsense_warn = C.NONSENSE_READ_WARN_THRESHOLD
    if preset.pb:
        nonsense_err = C.NONSENSE_READ_ERROR_THRESHOLD_PB
        nonsense_warn = C.NONSENSE_READ_WARN_THRESHOLD_PB

    file_format_code = guess_format(input_path)
    if file_format_code in (FORMAT_UNKNOWN, FORMAT_SAM):
        raise ValueError("unsupported input format")
    fastx_path = input_path
    if file_format_code in (FORMAT_BAM, FORMAT_FAST5):
        fastx_path = os.path.join(
            analysis_dir, "converted_seq_file%s.fastq" % sfx)

    logger.info("sampleqc started: %s preset=%s", input_path, preset_name)

    # ---------------- -d index prefetch (longQC.py:266-277) ----------------
    # build the overlap index concurrently with the chunk-QC loop; the
    # reference spawns `minimap2-coverage -d tempdb` here. Skipped for
    # BAM/FAST5 inputs (the fastx conversion happens inside the chunk
    # loop), exactly like the reference's `args.db and format != 0`.
    prefetcher = None
    if db and file_format_code not in (FORMAT_BAM, FORMAT_FAST5):
        main_cfg = C.overlap_config_for_sample(preset, fast=fast,
                                               index_size=index_size)
        specs = [(main_cfg.index.k, main_cfg.index.w,
                  os.path.join(mm2_dir, "t_db_longqc%s_k%d_w%d"
                               % (sfx, main_cfg.index.k,
                                  main_cfg.index.w)))]
        if short:
            scfg0 = C.overlap_config_for_sample(preset, fast=fast,
                                                index_size=index_size,
                                                short=True)
            if (scfg0.index.k, scfg0.index.w) != specs[0][:2]:
                specs.append((scfg0.index.k, scfg0.index.w,
                              os.path.join(
                                  mm2_dir, "t_db_longqc%s_k%d_w%d"
                                  % (sfx, scfg0.index.k, scfg0.index.w))))
        prefetcher = _IndexPrefetcher(input_path, specs,
                                      main_cfg.index.batch_size)
        prefetcher.start()
        logger.info("index prefetch started (-d): %d spec(s)", len(specs))

    # ---------------- chunk loop ----------------
    # The reference overlaps its chunk stages with worker pools:
    # adapter-cut and subsample ride Pool(2).apply_async
    # (longQC.py:280,314-341) and sdust a Pool of <= 10 subprocesses
    # (lq_mask.py:41,110). Same overlap here with threads: the next
    # chunk's parse prefetches on a reader thread while the current
    # chunk computes, and the masking stage (device dispatch + exact
    # host recursion for flagged reads) runs concurrently with the
    # adapter search / reservoir sampling / GC stages. JAX dispatch is
    # thread-safe; device programs serialize on-chip, so the win is the
    # host-side time (parse, exact sdust, bookkeeping).
    import concurrent.futures as cf
    import time as _time

    lm = MaskAccumulator(analysis_dir, suffix=suffix or "")
    lg = GCAccumulator(chunk_size=150)
    num_trim5 = num_trim3 = 0
    max_iden_adp5 = max_iden_adp3 = 0.0
    adp_pos5, adp_pos3 = [], []
    cum_n_seq = 0
    s_reads = []
    n_seqs = n_bases = 0
    chunk_n = 0
    t_wall0 = _time.time()
    t_mask = t_rest = 0.0
    chunk_iter = _prefetch_iter(open_seq_chunk(
        input_path, file_format_code,
        chunk_size=int(mem * 1024 ** 3), is_upper=True))
    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        for (reads, n_seqs, n_bases) in chunk_iter:
            if file_format_code in (FORMAT_BAM, FORMAT_FAST5):
                write_fastq(fastx_path, reads, is_chunk=True)
            logger.info("chunk %d: %d reads", chunk_n, len(reads))
            t0 = _time.time()
            mask_fut = pool.submit(lm.add_chunk, reads)
            if adp5 or adp3:
                trim_reads = ([copy.copy(r) for r in reads]
                              if trim_out else reads)
                work = trim_reads if trim_out else \
                    [list(r) for r in reads]  # search copies: stream stays
                res = cut_adapter(work, adp_t=adp5, adp_b=adp3,
                                  th=C.ADAPTER_IDENTITY_THRESHOLD,
                                  length=C.ADAPTER_SEARCH_LENGTH)
                if adp5 and adp3:
                    t5, t3 = res
                elif adp5:
                    t5, t3 = res, None
                else:
                    t5, t3 = None, res
                if trim_out:
                    write_fastq(trim_out, work, is_chunk=True)
                if t5:
                    if t5[0] > max_iden_adp5:
                        max_iden_adp5 = t5[0]
                    num_trim5 += t5[1]
                    adp_pos5.extend(t5[2])
                if t3:
                    if t3[0] > max_iden_adp3:
                        max_iden_adp3 = t3[0]
                    num_trim3 += t3[1]
                    adp_pos3.extend(t3[2])
            s_reads = subsample_from_chunk(reads, cum_n_seq, s_reads,
                                           nsample,
                                           s_seed=C.SUBSAMPLE_SEED)
            lg.add_batch(_pack(reads))
            t_rest += _time.time() - t0
            t0 = _time.time()
            mask_fut.result()
            t_mask += _time.time() - t0
            chunk_n += 1
            cum_n_seq = n_seqs
    logger.info("parsed input. #seqs:%d #bases:%d", n_seqs, n_bases)
    logger.info("chunk stages: %.1fs wall (adapter/sample/GC %.1fs "
                "overlapped with masking, +%.1fs mask wait)",
                _time.time() - t_wall0, t_rest, t_mask)
    lm.close()

    # ---------------- mask-based sample exclusion ----------------
    import pandas as pd
    df_mask = pd.read_table(lm.get_outfile_path(), sep="\t", header=None)
    exclude = df_mask[(df_mask[2] > C.MASK_EXCLUDE_LEN_1)
                      & (df_mask[3] > C.MASK_EXCLUDE_FRAC_1)][0].tolist()
    exclude += df_mask[(df_mask[2] > C.MASK_EXCLUDE_LEN_2)
                       & (df_mask[3] > C.MASK_EXCLUDE_FRAC_2)][0].tolist()

    s_reads = [r for r in s_reads if r != 0]
    ng_set = set(exclude)
    ng_idx = [i for i, r in enumerate(s_reads) if r[0] in ng_set]
    if ng_idx:
        logger.info("replacing %d masked sampled reads", len(ng_idx))
        for r in s_reads:
            ng_set.add(r[0])
        temp = [0] * len(ng_idx)
        j = 0
        for (reads, cn, _cb) in open_seq_chunk(
                input_path, file_format_code,
                chunk_size=int(0.1 * 1024 ** 3)):
            subsample_from_chunk(reads, j, temp, len(ng_idx),
                                 elist=ng_set, s_seed=C.SUBSAMPLE_SEED)
            j = cn
            if len([t for t in temp if t]) >= len(ng_idx):
                break
        if len([t for t in temp if t]) < len(ng_idx):
            logger.warning("replacement failed; dropping masked samples")
            for i in ng_idx:
                s_reads[i] = 0
            s_reads = [r for r in s_reads if r]
        else:
            for i, t in enumerate(temp):
                s_reads[ng_idx[i]] = t

    s_n_seqs = len([r for r in s_reads if r])
    ss_reads = []
    if short:
        # -b/--short: reads under the length threshold map with a more
        # sensitive setting and are merged back (longQC.py:107-112,
        # 409-415, 528-550)
        ss_reads = [r for r in s_reads
                    if r and len(r[1]) < C.SHORT_LENGTH_THRESHOLD]
        s_reads = [r for r in s_reads
                   if r and len(r[1]) >= C.SHORT_LENGTH_THRESHOLD]
        if ss_reads:
            write_fastq(os.path.join(
                analysis_dir, "short_subsample%s.fastq" % sfx), ss_reads)
    write_fastq(sample_path, s_reads)
    logger.info("subsample written: %d reads", s_n_seqs)

    # ---------------- overlap run ----------------
    cfg = C.overlap_config_for_sample(preset, fast=fast,
                                      index_size=index_size)

    def target_iter():
        return _read_stream(fastx_path if file_format_code in
                            (FORMAT_BAM, FORMAT_FAST5) else input_path)

    logger.info("overlap computation started")
    parts = cache = None
    if prefetcher is not None:
        parts = prefetcher.join()
        cache = prefetcher.cache_for(cfg.index.k, cfg.index.w)
        logger.info("index prefetch joined: %d part(s)",
                    len(parts) if parts else 0)
    rows = overlap_run(target_iter(), s_reads, cfg,
                       parts=parts, index_cache=cache)
    if short and ss_reads:
        scfg = C.overlap_config_for_sample(preset, fast=fast,
                                           index_size=index_size,
                                           short=True)
        scache = (prefetcher.cache_for(scfg.index.k, scfg.index.w)
                  if prefetcher is not None else None)
        rows = rows + overlap_run(target_iter(), ss_reads, scfg,
                                  parts=parts, index_cache=scache)
    with open(cov_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    logger.info("overlap computation finished")

    # ---------------- spike-in control filter (PacBio) ----------------
    control_rows = None
    if preset.pb:
        ref_path = _control_ref_path(preset.sequel)
        control_reads = [[n, s, "!" * len(s)]
                         for n, s, _q in iter_fastx(ref_path)] \
            if os.path.exists(ref_path) else []
        if control_reads:
            fcfg = C.overlap_config_for_filter()
            control_rows = overlap_run(list(control_reads), s_reads, fcfg)
            if short and ss_reads:
                control_rows = control_rows + overlap_run(
                    list(control_reads), ss_reads, fcfg)
            with open(os.path.join(
                    mm2_dir, "spiked_in_control%s.txt" % sfx), "w") as f:
                f.write("\n".join(control_rows) + "\n")

    # ---------------- analytics, plots, report ----------------
    gc_read_mean, gc_read_sd = plots.plot_unmasked_gc_frac(
        lg, fp=figp("gcfrac"))
    q7 = int(np.sum(df_mask[5].values))
    lengths = df_mask[2].values
    throughput = int(np.sum(lengths))
    longest = int(np.max(lengths))
    mean_len = float(np.mean(lengths))
    n50 = float(get_N50(lengths))

    plots.plot_qscore_dist(df_mask, 4, 2,
                           interval=n50 / 2 if n50 < 3000 else 3000,
                           fp=figp("average_qv"))
    plots.plot_masked_fraction(df_mask, fp=figp("masked_region"))
    g_a, g_b = estimate_gamma_dist(lengths)
    plots.plot_length_dist(figp("length"), lengths, g_a, g_b, longest,
                           mean_len, n50, bool(preset.pb))

    lc = CoverageAnalytics(rows, is_transcript=bool(transcript),
                           control_filtering=control_rows)
    lc.plot_coverage_dist(figp("coverage"))
    lc.plot_unmapped_frac_terminal(
        figp("terminal_analysis"),
        adp5_pos=(float(np.mean(adp_pos5))
                  if adp5 and adp_pos5 and np.mean(adp_pos5) > 0 else None),
        adp3_pos=(float(np.mean(adp_pos3))
                  if adp3 and adp_pos3 and np.mean(adp_pos3) > 0 else None))
    lc.plot_qscore_dist(figp("olp_qv"))
    lc.plot_length_vs_coverage(figp("coverage_over_read_length"),
                               interval=n50 / 2 if n50 < 3000 else 3000.0)

    very_low_coverage_mode = False
    if lc.is_no_coverage():
        pass
    elif ((transcript and float(lc.get_logn_mode() or 0)
           < C.VERY_LOW_COVERAGE_THRESHOLD)
          or (lc.is_low_coverage() and float(lc.get_logn_mode() or 0)
              < C.VERY_LOW_COVERAGE_THRESHOLD)
          or (lc.get_mean() is not None
              and float(lc.get_mean()) < C.VERY_LOW_COVERAGE_THRESHOLD)):
        very_low_coverage_mode = True
        if preset.pb:
            nonsense_err = C.NONSENSE_READ_ERROR_THRESHOLD_VERY_LOW_COV
            nonsense_warn = C.NONSENSE_READ_WARN_THRESHOLD_VERY_LOW_COV

    tobe_json = {
        "Yield": throughput,
        "Q7 bases": "%.2f%%" % (100 * q7 / throughput),
        "Longest_read": longest,
        "Num_of_reads": len(lengths),
        "Length_stats": {
            "gamma_params": [float(g_a), float(g_b)],
            "Mean_read_length": mean_len,
            "N50_read_length": n50,
        },
        "GC_stats": {
            "Mean_GC_content": float(gc_read_mean),
            "SD_GC_content": float(gc_read_sd),
        },
    }
    if adp5 and max_iden_adp5 >= C.ADAPTER_IDENTITY_THRESHOLD:
        tobe_json["Stats_for_adapter5"] = {
            "Num_of_trimmed_reads_5": num_trim5,
            "Max_identity_adp5": max_iden_adp5,
            "Average_position_from_5_end": float(np.mean(adp_pos5)),
        }
    if adp3 and max_iden_adp3 >= C.ADAPTER_IDENTITY_THRESHOLD:
        tobe_json["Stats_for_adapter3"] = {
            "Num_of_trimmed_reads_3": num_trim3,
            "Max_identity_adp3": max_iden_adp3,
            "Average_position_from_3_end": float(np.mean(adp_pos3)),
        }
    cov_stats = {"Estimated non-sense read fraction":
                 float(lc.get_unmapped_med_frac())}
    if lc.get_control_frac():
        cov_stats["Estimated spiked-in control read fraction"] = \
            float(lc.get_control_frac())
    if transcript or lc.is_low_coverage():
        cov_stats["Mode_coverage"] = float(lc.get_logn_mode())
        cov_stats["mu_coverage"] = float(lc.get_logn_mu())
        cov_stats["sigma_coverage"] = float(lc.get_logn_sigma())
    elif lc.is_no_coverage():
        cov_stats["Mean_coverage"] = "NA"
        cov_stats["SD_coverage"] = "NA"
    else:
        cov_stats["Mean_coverage"] = float(lc.get_mean())
        cov_stats["SD_coverage"] = float(lc.get_sd())
    cov_stats["Estimated crude Xome size"] = str(
        lc.calc_xome_size(throughput))
    tobe_json["Coverage_stats"] = cov_stats

    with open(json_path, "w") as f:
        json.dump(tobe_json, f, indent=4)

    # ----- HTML -----
    root = _build_root_dict(
        tobe_json, lc, preset, suffix, figp, s_n_seqs, throughput, q7,
        lengths, mean_len, n50, longest, file_format_code,
        adp5, adp3, max_iden_adp5, max_iden_adp3,
        num_trim5, num_trim3, adp_pos5, adp_pos3,
        nonsense_warn, nonsense_err, very_low_coverage_mode, transcript)
    render_report(root, html_path)
    logger.info("finished all processes.")
    root_logger_cleanup(fh)
    return tobe_json


class _IndexPrefetcher:
    """The -d/--db flow: stream the target reads, group them into index
    parts, and build + persist the host MinimizerIndex npz per part —
    all on a background thread overlapping the chunk-QC loop (the
    reference's `LqExec(minimap2-coverage -d tempdb)`, longQC.py:266-277;
    cache format npz instead of MMI)."""

    def __init__(self, input_path, specs, batch_size):
        import threading
        self.input_path = input_path
        self.specs = specs            # [(k, w, cache_prefix), ...]
        self.batch_size = batch_size
        self.parts = None
        self.error = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def _run(self):
        try:
            from longqc_tpu.engine import overlap_host as oh
            parts = list(oh.iter_index_parts(_read_stream(self.input_path),
                                             self.batch_size))
            for k, w, prefix in self.specs:
                for i, part in enumerate(parts):
                    path = "%s.part%04d.npz" % (prefix, i)
                    if not os.path.exists(path):
                        oh.build_index(part, k, w).save(path)
            self.parts = parts
        except Exception as e:  # surfaced on join()
            self.error = e

    def join(self):
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.parts

    def cache_for(self, k, w):
        for kk, ww, prefix in self.specs:
            if (kk, ww) == (k, w):
                return prefix
        return None


def _prefetch_iter(gen, depth=1):
    """Run a generator on a reader thread with a bounded queue: the
    next chunk parses while the current one computes (the kt_pipeline
    read stage, kthread.c:129-158)."""
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    DONE = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(DONE)
        except BaseException as e:   # surfaced on the consumer side
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def root_logger_cleanup(fh):
    logging.getLogger().removeHandler(fh)
    fh.close()


def _pack(reads):
    from longqc_tpu.io.pack import pack_reads
    return pack_reads(reads)


def _read_stream(path):
    for name, seq, qual in iter_fastx(path):
        yield [name, seq.upper(), qual if qual else "!" * len(seq)]


def _build_root_dict(tobe_json, lc, preset, suffix, figp, s_n_seqs,
                     throughput, q7, lengths, mean_len, n50, longest,
                     file_format_code, adp5, adp3, iden5, iden3,
                     num_trim5, num_trim3, adp_pos5, adp_pos3,
                     nonsense_warn, nonsense_err, very_low_cov, transcript):
    root = {}
    root["suffix"] = (" - " + suffix) if suffix else ""
    stats = OrderedDict()
    stats["Sample name"] = suffix if suffix else "-"
    stats["Yield"] = throughput
    stats["Number of reads"] = len(lengths)
    if preset.sequel or file_format_code == FORMAT_FASTA:
        stats["Q7 bases"] = "-"
    else:
        stats["Q7 bases"] = "%.3f%%" % (100 * q7 / throughput)
    stats["Longest read"] = longest
    if lc.get_unmapped_med_frac():
        stats["Estimated non-sense read fraction"] = \
            "%.3f" % lc.get_unmapped_med_frac()
    if lc.get_control_frac():
        stats["Estimated spiked-in control read fraction"] = \
            "%.3f" % lc.get_control_frac()
    root["stats"] = stats

    if ((adp5 and iden5 >= C.ADAPTER_IDENTITY_THRESHOLD)
            or (adp3 and iden3 >= C.ADAPTER_IDENTITY_THRESHOLD)):
        ad = OrderedDict()
        if adp5 and iden5 >= C.ADAPTER_IDENTITY_THRESHOLD:
            ad["Number of trimmed reads in 5'"] = num_trim5
            ad["Max seq identity for the adapter in 5'"] = "%.3f" % iden5
            ad["Average trimmed length in 5'"] = \
                "%.3f" % float(np.mean(adp_pos5))
        if adp3 and iden3 >= C.ADAPTER_IDENTITY_THRESHOLD:
            ad["Number of trimmed reads in 3'"] = num_trim3
            ad["Max seq identity for the adapter in 3'"] = "%.3f" % iden3
            ad["Average trimmed length in 3'"] = \
                "%.3f" % float(np.mean(adp_pos3))
        root["ad"] = ad

    root["rl"] = {"name": enc_b64_str(figp("length")),
                  "stats": OrderedDict([
                      ("Mean read length", "%.3f" % mean_len),
                      ("N50", "%.3f" % n50)])}
    root["rq"] = {"name": enc_b64_str(figp("average_qv"))}

    rc_stats = OrderedDict([("Number of sampled reads", s_n_seqs)])
    if lc.is_no_coverage():
        rc_stats["Mean per read coverage"] = "N/A"
        rc_stats["S.D. per read coverage"] = "N/A"
    elif transcript or lc.is_low_coverage():
        rc_stats["Mode of per read coverage"] = "%.3f" % lc.get_logn_mode()
        rc_stats["mu of per read coverage"] = "%.3f" % lc.get_logn_mu()
        rc_stats["sigma of per read coverage"] = \
            "%.3f" % lc.get_logn_sigma()
    else:
        rc_stats["Mean per read coverage"] = "%.3f" % lc.get_mean()
        rc_stats["S.D. per read coverage"] = "%.3f" % lc.get_sd()
    rc_stats["Crude estimated Xome size"] = lc.calc_xome_size(throughput)
    root["rc"] = {
        "cov_plot_name": enc_b64_str(figp("coverage")),
        "cov_over_len_plot_name":
            enc_b64_str(figp("coverage_over_read_length")),
        "cov_ovlp_qv_plot_name": enc_b64_str(figp("olp_qv")),
        "stats": rc_stats,
    }
    root["gc"] = {"name": enc_b64_str(figp("gcfrac")),
                  "stats": OrderedDict([
                      ("Mean per read GC content", "%.3f %%"
                       % (100.0 * tobe_json["GC_stats"]["Mean_GC_content"])),
                      ("s.d. per read GC content", "%.3f %%"
                       % (100.0 * tobe_json["GC_stats"]["SD_GC_content"]))])}
    root["fr"] = {"name": enc_b64_str(figp("terminal_analysis"))}
    root["sc"] = {"name": enc_b64_str(figp("masked_region"))}

    warns = OrderedDict()
    errors = OrderedDict()
    if not preset.sequel and file_format_code == 2:
        fq7 = q7 / throughput
        if C.Q7_ERROR_FRACTION < fq7 <= C.Q7_WARN_FRACTION:
            warns["Low Q7"] = "This value should be higher than 65%."
        elif fq7 <= C.Q7_ERROR_FRACTION:
            errors["Too low Q7"] = ("This value should be higher than 50%. "
                                    "Ideally, higher than 65%.")
    if lc.is_no_coverage():
        errors["Coverage estimation failure"] = (
            "Coverage estimation cannot be made. No or very little "
            "coverage data exists.")
    elif very_low_cov:
        if lc.is_low_coverage():
            warns["Low coverage"] = \
                "Coverage of data looks to be very low/skewed."
        else:
            warns["Low coverage"] = "Coverage of data looks to be very low."
        e_zero = lc.get_expected_zero_rate()
        adj_e = lc.get_unmapped_med_frac() - e_zero[1]
        if nonsense_warn <= adj_e < nonsense_err:
            warns["High non-sense read fraction"] = (
                "This value should be lower than %.2f%%."
                % ((nonsense_warn + e_zero[1]) * 100))
        elif adj_e >= nonsense_err:
            errors["Too high non-sense read fraction"] = (
                "This value should not be higher than %.2f%%."
                % ((nonsense_err + e_zero[1]) * 100))
    else:
        umf = lc.get_unmapped_med_frac()
        if nonsense_warn <= umf < nonsense_err:
            warns["High non-sense read fraction"] = (
                "This value should be lower than %d%%."
                % int(nonsense_warn * 100))
        elif umf >= nonsense_err:
            errors["Too high non-sense read fraction"] = (
                "This value should not be higher than %d%%."
                % int(nonsense_err * 100))
    if num_trim5 and not preset.pb:
        if num_trim5 / len(lengths) <= C.ADAPTER_TRIM5_WARN_FRACTION:
            warns["Low number of adapter hits in 5'"] = (
                "This value should be higher than 30% if adapter "
                "sequences were not removed.")
    for e in lc.get_errors():
        errors[e[0]] = e[1]
    for w_ in lc.get_warnings():
        warns[w_[0]] = w_[1]
    root["warns"] = warns
    root["errors"] = errors
    if preset.pb:
        root["pb"] = True
    if preset.sequel:
        root["sequel"] = True
    return root
