"""Command-line interface: `python -m longqc_tpu <subcommand>`.

Mirrors the reference CLI surface (longQC.py:868-956): `sampleqc` with
the same presets/options and `runqc` for per-instrument platform QC.
"""

import argparse
import sys

from longqc_tpu._version import __version__
from longqc_tpu.config import PRESETS, DEFAULT_N_SAMPLE


def command_run(args):
    from longqc_tpu.platform import nanopore, rs, sequel
    suf = args.suf
    if args.platform == "rs2":
        rs.run_platformqc(args.raw_data_dir, args.out, suffix=suf)
    elif args.platform == "sequel":
        sequel.run_platformqc(args.raw_data_dir, args.out, suffix=suf)
    elif args.platform in ("minion", "gridion"):
        nanopore.run_platformqc(args.platform, args.raw_data_dir, args.out,
                                suffix=suf, n_channel=512)


def command_sample(args):
    from longqc_tpu.engine.pipeline import run_sampleqc
    run_sampleqc(
        args.input, args.out, args.preset,
        nsample=args.nsample, transcript=bool(args.transcript),
        suffix=args.suf, trim_out=args.trim, adp5=args.adp5,
        adp3=args.adp3, fast=bool(args.fast), mem=args.mem,
        index_size=args.inds, short=bool(args.short),
        db=bool(args.db), ncpu=args.ncpu, force_pb=args.pb,
        force_sequel=args.sequel, force_ont=args.ont)


def command_help(args):
    # the reference's `help <command>` subcommand (longQC.py:952-954):
    # print the named subcommand's help
    build_parser().parse_args([args.command, "--help"])


def command_mmcov(args):
    """Debug surface mirroring the minimap2-coverage binary CLI
    (minimap2-coverage.c:37-197): emit the 9-column coverage TSV on
    stdout; -d dumps/loads the npz index cache; -z additionally runs the
    minimizer-count aggregation (the reference computes it and discards
    the output — its printfs are commented out, :478-543 — so ours goes
    to stderr where it cannot disturb the TSV contract)."""
    import sys

    import numpy as np

    from longqc_tpu.config import OverlapConfig, IndexOpt, MapOpt, FltOpt
    from longqc_tpu.engine import overlap_host as oh
    from longqc_tpu.engine.overlap import overlap_run_device
    from longqc_tpu.io.fastx import iter_fastx

    cfg = OverlapConfig(
        index=IndexOpt(k=args.k, w=args.w, is_hpc=bool(args.hpc),
                       batch_size=_parse_size(args.inds)),
        map=MapOpt(min_score_med=args.p, min_score_good=args.q,
                   min_chain_score=args.m),
        flt=FltOpt(min_ovlp=args.l, min_coverage=args.c),
        filter_mode=bool(args.filter),
    )

    def target_iter():
        return ([n, s, q or ""] for n, s, q in iter_fastx(args.target))

    if args.query is None:
        if not args.db:
            raise SystemExit("mmcov: no query given and -d not set")
        # index-dump-only mode (minimap2-coverage.c:460-468)
        for i, part in enumerate(oh.iter_index_parts(
                target_iter(), cfg.index.batch_size)):
            oh.build_index(part, args.k, args.w,
                           is_hpc=cfg.index.is_hpc).save(
                "%s.part%04d.npz" % (args.db, i))
        return

    queries = [[n, s, q or ""] for n, s, q in iter_fastx(args.query)]
    if args.z:
        # -z needs the per-read m_cnts state: run the host spec path,
        # which returns it (the device engine keeps m_cnts on device)
        rows, states, q_sk = oh.overlap_run_with_states(
            target_iter(), queries, cfg, index_cache=args.db or None)
        counts = oh.aggregate_minimizer_counts(q_sk, states)
        for j, cval in enumerate(np.asarray(counts).tolist()):
            print("[z] minimizer %d cnt: %d" % (j, cval),
                  file=sys.stderr)
    elif args.db:
        # -d with a query: build-or-load the npz cache, then map (the
        # reference's tempdb flow); exact host spec path owns the cache
        rows = oh.overlap_run(target_iter(), queries, cfg,
                              index_cache=args.db)
    else:
        rows = overlap_run_device(target_iter(), queries, cfg)
    sys.stdout.write("\n".join(rows) + "\n")


def _parse_size(s):
    from longqc_tpu.config import parse_num
    return parse_num(s)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="longqc_tpu",
        description="Quality control for long-read sequence data.")
    parser.add_argument("-v", "--version", action="version",
                        version="%(prog)s " + __version__)
    sub = parser.add_subparsers()

    platforms = ["rs2", "sequel", "minion", "gridion"]
    p_run = sub.add_parser("runqc", help="per-run instrument QC")
    p_run.add_argument("-s", "--suffix", dest="suf", default=None)
    p_run.add_argument("-o", "--output", dest="out", default=None)
    p_run.add_argument("platform", choices=platforms)
    p_run.add_argument("raw_data_dir", type=str)
    p_run.set_defaults(handler=command_run)

    p_s = sub.add_parser("sampleqc", help="reference-free sample QC")
    p_s.add_argument("input", help="input [fasta, fastq, pbbam or fast5 dir]")
    p_s.add_argument("-o", "--output", dest="out", required=True)
    p_s.add_argument("-x", "--preset", choices=sorted(PRESETS),
                     required=True)
    p_s.add_argument("-t", "--transcript", dest="transcript",
                     action="store_true", default=None)
    p_s.add_argument("-n", "--n_sample", dest="nsample", type=int,
                     default=DEFAULT_N_SAMPLE)
    p_s.add_argument("-s", "--sample_name", dest="suf", default=None)
    p_s.add_argument("-c", "--trim_output", dest="trim", default=None)
    p_s.add_argument("--adapter_5", dest="adp5", default=None)
    p_s.add_argument("--adapter_3", dest="adp3", default=None)
    p_s.add_argument("-f", "--fast", dest="fast", action="store_true",
                     default=None)
    p_s.add_argument("-m", "--mem", dest="mem", type=float, default=0.5)
    p_s.add_argument("-i", "--index", dest="inds", default="4G")
    p_s.add_argument("-b", "--short", dest="short", action="store_true",
                     default=None)
    p_s.add_argument("-p", "--ncpu", dest="ncpu", type=int, default=4,
                     help="host-thread budget (advisory: stages run as "
                          "in-process device programs here)")
    p_s.add_argument("-d", "--db", dest="db", action="store_true",
                     default=False,
                     help="build the overlap index in parallel to other "
                          "tasks (persisted as npz parts)")
    # hidden expert flags (longQC.py:942-947)
    p_s.add_argument("--pb", help=argparse.SUPPRESS, dest="pb",
                     action="store_true", default=None)
    p_s.add_argument("--sequel", help=argparse.SUPPRESS, dest="sequel",
                     action="store_true", default=None)
    p_s.add_argument("--ont", help=argparse.SUPPRESS, dest="ont",
                     action="store_true", default=None)
    p_s.set_defaults(handler=command_sample)

    # debug surface of the overlap engine (the minimap2-coverage binary
    # CLI, minimap2-coverage.c:37-197)
    p_m = sub.add_parser("mmcov",
                         help="overlap-coverage engine (debug surface)")
    p_m.add_argument("target")
    p_m.add_argument("query", nargs="?", default=None)
    p_m.add_argument("-k", type=int, default=12)
    p_m.add_argument("-w", type=int, default=5)
    p_m.add_argument("-H", dest="hpc", action="store_true", default=False)
    p_m.add_argument("-I", dest="inds", default="4G")
    p_m.add_argument("-m", type=int, default=40,
                     help="min chain score")
    p_m.add_argument("-p", type=int, default=80,
                     help="medium chain score threshold")
    p_m.add_argument("-q", type=int, default=160,
                     help="good chain score threshold")
    p_m.add_argument("-l", type=int, default=0, help="min overlap len")
    p_m.add_argument("-c", type=int, default=3, help="min coverage")
    p_m.add_argument("-d", dest="db", default=None,
                     help="npz index cache path prefix (dump-only when "
                          "no query is given)")
    p_m.add_argument("-z", dest="z", action="store_true", default=False,
                     help="minimizer-count aggregation (reported on "
                          "stderr; the reference computes and discards "
                          "it, minimap2-coverage.c:478-543)")
    p_m.add_argument("--filter", dest="filter", action="store_true",
                     default=False)
    p_m.set_defaults(handler=command_mmcov)

    p_h = sub.add_parser("help", help="see `help -h`")
    p_h.add_argument("command")
    p_h.set_defaults(handler=command_help)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if hasattr(args, "handler"):
        args.handler(args)
    else:
        parser.print_help()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
