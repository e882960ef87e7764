"""Device-path overlap entry point, and the batched-chainer path.

Same pipeline as engine/overlap_host.overlap_run, with chaining done by
the resumable batched device kernel (ops/chain.py): query anchor sets
are packed into a single fixed (Q, A) shape and streamed through the
kernel chunk by chunk with explicit ring carry — one compiled program
per process regardless of anchor counts. Flagged rows (ring truncation
or unresolved max_skip fixpoint) fall back to the exact host DP; chain
extraction/coverage accounting stay on host. Output rows are
bit-identical to the host spec (differentially tested).
"""

import os
from logging import getLogger

import numpy as np

from longqc_tpu.config import OverlapConfig
from longqc_tpu.engine import overlap_host as oh
from longqc_tpu.ops.chain import (backtrack_chains, chain_dp_batch,
                                  gap_penalty_table, make_carry)

logger = getLogger(__name__)

_GROUP_Q = 64       # device batch rows per DP call
_CHUNK_A = 2048     # anchors per chunk (single compiled shape)


class DeviceChainer:
    """Batched resumable chain-DP dispatcher with host fallback, usable
    as the `chain_many` hook of overlap_run."""

    def __init__(self, J=64):
        self.J = J
        self.n_host_fallback = 0
        self.n_device = 0

    def _collect(self, sel, anchor_sets, m, results, fs, ps, vs, flags):
        for r, i in enumerate(sel):
            ax, ay = anchor_sets[i]
            n = len(ax)
            if flags[r]:
                self.n_host_fallback += 1
                results[i] = oh.chain_dp(
                    ax, ay, m.max_gap, m.bw, m.max_chain_skip,
                    m.min_cnt, m.min_chain_score)
            else:
                self.n_device += 1
                results[i] = backtrack_chains(
                    fs[r], ps[r], vs[r], n, m.min_cnt, m.min_chain_score)

    def _run_group(self, sel, anchor_sets, m, results):
        Q, A = _GROUP_Q, _CHUNK_A
        ns = np.array([len(anchor_sets[i][0]) for i in sel], np.int64)
        n_max = int(ns.max())
        nb = np.zeros((Q,), np.int32)
        nb[:len(sel)] = ns
        pen = np.zeros((Q, m.bw + 1), np.int32)
        split = []
        for r, i in enumerate(sel):
            ax, ay = anchor_sets[i]
            hi = (ax >> np.uint64(32)).astype(np.uint32).view(np.int32)
            lo = (ax & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
            qq = (ay & np.uint64(0xFFFFFFFF)).astype(np.int32)
            sp = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
            split.append((hi, lo, qq, sp))
            pen[r] = gap_penalty_table(np.float32(sp.sum() / len(sp)),
                                       m.bw)

        carry = make_carry(Q, self.J)
        fs = np.zeros((Q, n_max), np.int32)
        ps = np.full((Q, n_max), -1, np.int32)
        vs = np.zeros((Q, n_max), np.int32)
        flags = np.zeros((Q,), bool)
        for c0 in range(0, n_max, A):
            axh = np.zeros((Q, A), np.int32)
            axl = np.zeros((Q, A), np.int32)
            aqb = np.zeros((Q, A), np.int32)
            asb = np.zeros((Q, A), np.int32)
            for r, _ in enumerate(sel):
                hi, lo, qq, sp = split[r]
                seg = slice(c0, min(c0 + A, len(hi)))
                ln = seg.stop - seg.start
                if ln > 0:
                    axh[r, :ln] = hi[seg]
                    axl[r, :ln] = lo[seg]
                    aqb[r, :ln] = qq[seg]
                    asb[r, :ln] = sp[seg]
            f, p, v, fl, carry = chain_dp_batch(
                axh, axl, aqb, asb, nb, pen, carry, np.int32(c0),
                J=self.J, max_dist=m.max_gap, bw=m.bw,
                max_skip=m.max_chain_skip)
            hi_end = min(c0 + A, n_max)
            fs[:, c0:hi_end] = np.asarray(f)[:, :hi_end - c0]
            ps[:, c0:hi_end] = np.asarray(p)[:, :hi_end - c0]
            vs[:, c0:hi_end] = np.asarray(v)[:, :hi_end - c0]
            flags |= np.asarray(fl)
        self._collect(sel, anchor_sets, m, results, fs, ps, vs, flags)

    def __call__(self, anchor_sets, m):
        results = [None] * len(anchor_sets)
        nonempty = []
        for i, (ax, ay) in enumerate(anchor_sets):
            if len(ax) == 0:
                results[i] = []
            else:
                nonempty.append(i)
        # sort by anchor count: groups stay homogeneous, chunk loops
        # don't run long tails for short rows
        nonempty.sort(key=lambda i: len(anchor_sets[i][0]))
        gq = _GROUP_Q
        for off in range(0, len(nonempty), gq):
            self._run_group(nonempty[off:off + gq], anchor_sets, m,
                            results)
        return results


def overlap_run_device(target_iter, query_reads, cfg: OverlapConfig,
                       progress=None, J=64, parts=None, index_cache=None):
    """Device-path overlap run -> 9-column TSV rows.

    Dispatches to the device-resident engine (engine/device_overlap,
    the flagship hot path) for every supported config: 2k <= 30 runs
    carry i32 hash lanes, k up to 28 (pb-hifi fast, -k 19 -w 10,
    longQC.py:222-231) carries i64 wide-hash lanes, and HPC-sketch
    runs (the spike-in --filter, pb-hifi) use the packed-key path.
    Only configs the device engine rejects (HPC with k > 15 — no
    reference surface) fall back to the round-1 batched-chainer path.
    Override with LONGQC_OVERLAP_ENGINE=v1|v2.

    parts: pre-grouped part read-lists (the -d prefetch path).
    index_cache: npz path prefix for host-index persistence (only the
    batched-chainer path consumes it; the device-resident engine builds
    its index on device each part, which is cheaper than a host load).
    """
    choice = os.environ.get("LONGQC_OVERLAP_ENGINE", "")
    if choice != "v1":
        try:
            from longqc_tpu.engine.device_overlap import \
                overlap_run_device2
            return overlap_run_device2(target_iter, query_reads, cfg,
                                       progress=progress, parts=parts)
        except NotImplementedError:
            if choice == "v2":
                raise
            logger.info("device engine unavailable for this config; "
                        "using the batched-chainer path")
    chainer = DeviceChainer(J=J)
    rows = oh.overlap_run(target_iter, query_reads, cfg,
                          progress=progress, chain_many=chainer,
                          parts=parts, index_cache=index_cache)
    if chainer.n_host_fallback:
        logger.info("chain DP: %d device rows, %d host fallbacks",
                    chainer.n_device, chainer.n_host_fallback)
    return rows
