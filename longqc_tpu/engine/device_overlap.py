"""Device-resident overlap-coverage engine (the sampleqc hot path).

The whole per-part pipeline stays on the device, and each call pulls
only O(queries) bytes back to the host:

  part reads --pack/push--> sketch kernel --> flat (hash, rid, pos)
    --> multi-key lax.sort index + weighted occurrence prefix  [device]
  per query group (Q=128 lanes):
    searchsorted seed lookup -> weighted anchor expansion -> per-row
    stable sort -> chain DP fill -> peak + min-rank ring passes
    (ops/chain_ring; chain extraction per ops/chainsel's closed form) ->
    reg geometry + lambda/lambda2/m_cnts accounting + interval
    compression (lq_cnt_match + filter_redundant_coords semantics)
    entirely on device; the call returns the compressed interval events
    (a few KB) and tiny per-row stats.

Exactness contract: rows are bit-identical to engine/overlap_host
(itself row-identical to the reference binaries). Any situation the
device math cannot reproduce exactly — chain-DP ring truncation or
max_skip fixpoint disagreement, m_cnts uint16 saturation, interval
buffer overflow, an overhang-ratio comparison within f64 rounding
distance of the threshold — raises a per-(row, part) flag; the flagged
row's state update is discarded and recomputed by the host spec for
that part while the part's reads are still in memory.

Behavioral citations as in overlap_host.py: index.c:69-144 (index +
occurrence threshold), lqmap.c:140-205 (seed collection), chain.c:22-157
(chain DP + extraction), esterr.c:72-140 (coverage accounting),
lqmap.c:25-100 (interval compression), minimap2-coverage.c:545-617
(output rows).
"""

import functools
import time
from bisect import bisect_left
from collections import defaultdict
from dataclasses import dataclass
from logging import getLogger

import jax
import jax.numpy as jnp
import numpy as np

from longqc_tpu import backend
from longqc_tpu.config import OverlapConfig
from longqc_tpu.engine import device_index as di
from longqc_tpu.engine import overlap_host as oh
from longqc_tpu.io.pack import pack_reads
from longqc_tpu.ops.chain_ring import (INF32, chain_fill, make_ring_carry,
                                       minrank_pass, peak_pass,
                                       penalty_limbs)
from longqc_tpu.ops.sketch import sketch_batch

logger = getLogger(__name__)

GROUP_Q = 128          # query lanes per step call
J = 64                 # chain-DP ring depth (ops/chain_ring)
J_RETRY = 512          # ring depth of the F_KERNEL retry
CV = 512               # max accepted chains per (row, part) call
EOUT = 4 * CV          # max emitted interval events per call
EV_B = 8192            # cross-row compacted event budget per pull
# anchor-capacity rungs of the step program. The rung is picked per
# (part, group) from a count pass before the step is dispatched, so a
# step runs at the smallest rung that fits every live row. On the GPU a
# step costs milliseconds and each distinct step program ~10 s to
# compile, so the ladder is kept short. Rows past the top rung are
# computed by the exact host path.
A_BUCKETS = (2048, 8192, 32768, 131072)
# canonical per-part read-count paddings (rid-indexed arrays in the
# step program); rid packs into 24 bits
B_PADS = (8192, 1 << 17, 1 << 21, 1 << 24)

# flag bits (per row, per call)
F_KERNEL = 1           # chain kernel truncation / max_skip disagreement
F_SAT = 2              # m_cnts approaching uint16 saturation
F_CV = 4               # more accepted chains than CV
F_GEOM = 8             # overhang-ratio compare within f64 rounding noise
F_ANCH = 16            # anchors exceed the largest A bucket
F_EXP = 32             # expanded minimizers exceed M2


def _ratio_limbs(min_ratio):
    """Exact dyadic representation p/2^s of the f64 ratio, split into
    27-bit limbs for the overflow-free integer comparison
    a >= total*ratio (see _geom_ok)."""
    p, q = float(min_ratio).as_integer_ratio()
    s = q.bit_length() - 1
    assert q == 1 << s and p >= 0
    return int(p >> 27), int(p & ((1 << 27) - 1)), int(s)


@dataclass(frozen=True)
class StepStatic:
    """Hashable static configuration of the step program."""
    Q: int
    M: int
    M2: int
    A: int
    k: int
    max_gap: int
    bw: int
    max_skip: int
    min_cnt: int
    min_sc: int
    min_sc_m: int
    min_sc_g: int
    max_overhang: int
    min_cov: int
    covt: int
    ava: bool
    p_hi: int
    p_lo: int
    p_s: int
    chain: str          # ring passes: "cuda" kernels or "scan" forms
    jring: int = J      # chain-DP ring depth (64; 512 = F_KERNEL retry)


def _async_pull(arr):
    """Start a device->host copy without blocking (the transfer
    overlaps subsequent dispatch work); np.asarray later is a wait."""
    try:
        arr.copy_to_host_async()
    except AttributeError:
        pass


def _ss_left_2level(ih, q, n_coarse=8192):
    """Left-side searchsorted of q (any shape) into sorted 1-D ih in
    two levels: jnp.searchsorted is log2(N) = 23 gather sweeps over the
    full index, while a boundary-counting compare-reduce is dense
    arithmetic. Phase 1 counts boundaries (every S-th hash) strictly
    below q — one fused (nq, B) compare-sum — which pins left(q) into
    an S-wide window; phase 2 binary-searches the window with
    ceil(log2(S+1)) gather sweeps whose addresses are S-local (cache
    friendly). Exactness: ih[(c-1)S] < q <= ih[cS] brackets the first
    i with ih[i] >= q by the boundary-count invariant; the refine loop
    is the textbook left-bisect. Differentially tested against
    jnp.searchsorted; whether it beats the builtin on the GPU is not
    measured yet."""
    N = ih.shape[0]
    # scale the boundary count with N: the compare-sum costs
    # nq * n_coarse ops, so a fixed 8192 at mid widths would dwarf the
    # gather sweeps it saves (acute on the CPU test backend)
    n_coarse = min(n_coarse, max(N // 1024, 1))
    if N % n_coarse or N // n_coarse < 4:
        return jnp.searchsorted(ih, q, side="left").astype(jnp.int32)
    S = N // n_coarse
    bnd = ih[::S]
    qf = q.reshape(-1)
    c = jnp.sum((bnd[None, :] < qf[:, None]).astype(jnp.int32),
                axis=1)
    lo = jnp.where(c > 0, (c - 1) * S + 1, 0)
    hi = jnp.minimum(c * S, N)
    steps = int(np.ceil(np.log2(S + 1)))
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = ih[jnp.clip(mid, 0, N - 1)]
        go = active & (v < qf)
        lo = jnp.where(go, mid + 1, lo)
        hi = jnp.where(active & ~go, mid, hi)
    return lo.reshape(q.shape).astype(jnp.int32)


def _ss_ck(ih_stack, bnd_ck, qck, *, kb):
    """Left-side search of virtual keys qck (int64, see device_index's
    _shard_ck_note) over the (S, Ns) hash-range shard stack, treated
    as one globally ck-monotone flat array. Same two-level structure
    as _ss_left_2level: boundary compare-sum, then window-local gather
    sweeps that reconstruct ck from (flat >> lgNs, flat & (Ns-1))."""
    S, Ns = ih_stack.shape
    Ntot = S * Ns
    lgN = Ns.bit_length() - 1
    stride = Ntot // bnd_ck.shape[0]
    qf = qck.reshape(-1)
    c = jnp.sum((bnd_ck[None, :] < qf[:, None]).astype(jnp.int32),
                axis=1)
    lo = jnp.where(c > 0, (c - 1) * stride + 1, 0)
    hi = jnp.minimum(c * stride, Ntot)
    one = jnp.int64(1)
    steps = int(np.ceil(np.log2(stride + 1)))
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        mc = jnp.clip(mid, 0, Ntot - 1)
        v = ih_stack[mc >> lgN, mc & (Ns - 1)].astype(jnp.int64)
        ck = ((mc >> lgN).astype(jnp.int64) << kb) + \
            jnp.minimum(v, one << kb)
        go = active & (ck < qf)
        lo = jnp.where(go, mid + 1, lo)
        hi = jnp.where(active & ~go, mid, hi)
    return lo.reshape(qck.shape).astype(jnp.int32)


def _seg_fill_last(mask, val, fill):
    """Per row: at each position, the latest `val` at or before it where
    mask is set (fill until the first set position)."""
    Q, L = mask.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    lb = jax.lax.associative_scan(
        jnp.maximum, jnp.where(mask, pos, -1), axis=1)
    safe = jnp.clip(lb, 0, L - 1)
    out = jnp.take_along_axis(val, safe, axis=1)
    return jnp.where(lb >= 0, out, fill)


def _compact_rows(keys, payloads, width, fill_key):
    """Per-row stable compaction: entries with key != fill_key move to
    the front (in original order); returns truncated (Q, width) arrays
    plus per-row valid counts. Cumsum + scatter (targets are unique
    for valid entries, so the scatter is deterministic) — ~2x cheaper
    than the multi-operand stable sort it replaces; slots past the
    valid count hold fill_key/0 (every caller masks by n)."""
    Q, L = keys.shape
    valid = keys != fill_key
    tgt = jnp.cumsum(valid.astype(jnp.int32), axis=1) - 1
    rows = jax.lax.broadcasted_iota(jnp.int32, (Q, L), 0)
    tgt_c = jnp.where(valid & (tgt < width), tgt, width)
    n = jnp.sum(valid, axis=1).astype(jnp.int32)

    def scat(a, fill):
        out = jnp.full((Q, width + 1), fill, a.dtype)
        return out.at[rows, tgt_c].set(a, mode="drop")[:, :width]

    return scat(keys, fill_key), [scat(p, 0) for p in payloads], n


# ---------------------------------------------------------------------------
# part index build


# ---------------------------------------------------------------------------
# query group preparation


@jax.jit
def _pack_group_slots(qpos, qstrand, qcnt, n_slots):
    """Per-slot packed minimizer (pos << 1 | strand) and the group's
    total expanded-entry counts (the mini_pos length the reference
    divides m_cnts by, minimap2-coverage.c:545-563)."""
    Q, M = qpos.shape
    slot_ok = jnp.arange(M, dtype=jnp.int32)[None, :] < n_slots[:, None]
    qps = (qpos << 1) | qstrand
    n_exp = jnp.sum(jnp.where(slot_ok, qcnt, 0),
                    axis=1).astype(jnp.int32)
    return qps, n_exp


@functools.partial(jax.jit, static_argnames=("mcrop",))
def _count_expanded(ih, qh, qcnt, n_slots, mid_occ, *, mcrop=None):
    """Per-row expanded-anchor count n_q — the quantity F_ANCH guards —
    with no A-dimension work: sum over kept minimizer slots of
    (duplicate multiplicity x index occurrence count). Dispatched ahead
    of each (part, group) step so the step runs at the smallest anchor
    rung that fits every row (the reference plays the same pre-sizing
    trick for m_cnts, minimap2-coverage.c:406-431).

    Also returns the seed-lookup tables (left, occ) per slot: the
    searchsorted against the canonical index is the count's only
    expensive op, and the step program consumes exactly the same
    tables — returning them halves the per-(part, group) lookup work
    (round 4 ran the identical searchsorted pair twice).

    All arithmetic stays int32: per-slot contributions saturate at 65535 and
    accumulate in 1024-slot blocks whose partial sums clamp at 2^23,
    so the outer sum stays below 2^30 for EVERY length bucket
    (M <= 2^17: reads past 65536 bp land in the 262144 bucket) and
    the count is monotone — it can only saturate, never wrap. The
    only decision the caller makes is picking the smallest rung
    >= n_q (rungs top out at 65536 << 2^23), so a clamped row always
    picks the right rung or forces the host path; an underestimate
    from per-slot saturation at most sends a pathological row through
    the F_ANCH safety net to the exact host fallback.

    mcrop (static): search only the first mcrop slots. The search's
    cost is linear in slot count, and real slots are typically ~40% of
    M (minimizer density 2/(w+1)). The caller picks the smallest rung in {M/4, M/2, M}
    >= the group's max n_slots (known exactly from the staging pull),
    so cropping never drops a real slot; left/occ pad back to (Q, M)
    with zeros, which the step treats identically to padding slots
    (qcnt == 0 there contributes no anchors)."""
    Q, M = qh.shape
    mc = M if mcrop is None else min(mcrop, M)
    qh_c = qh[:, :mc]
    qcnt_c = qcnt[:, :mc]
    slot_on = jnp.arange(mc, dtype=jnp.int32)[None, :] < n_slots[:, None]
    # padding slots search the constant 0 (uniform gather addresses —
    # the refine sweeps coalesce) — their left/occ are never consumed
    qs = jnp.where(slot_on, qh_c, 0)
    # right(q) == left(q+1) for integer keys (hashes < 2^2k < sentinel)
    lr = _ss_left_2level(ih, jnp.concatenate([qs, qs + 1], axis=1))
    left = lr[:, :mc]
    occ = lr[:, mc:] - left
    out = _count_tail(occ, qcnt_c, slot_on, mid_occ)
    if mc < M:
        pad = ((0, 0), (0, M - mc))
        left = jnp.pad(left, pad)
        occ = jnp.pad(occ, pad)
    return out + (left, occ)


def _count_tail(occ, qcnt, slot_on, mid_occ):
    Q, M = occ.shape
    CAP = jnp.int32(65535)
    HALF = jnp.int32(1 << 15)
    kept = slot_on & (occ < mid_occ)
    sat = (occ > HALF) | (qcnt > HALF)
    prod = jnp.minimum(occ, HALF) * jnp.minimum(qcnt, HALF)  # <= 2^30
    contrib = jnp.where(kept, jnp.where(sat, CAP,
                                        jnp.minimum(prod, CAP)), 0)
    BLK = 1024 if M % 1024 == 0 else M
    part = jnp.sum(contrib.reshape(Q, M // BLK, BLK), axis=2)
    part = jnp.minimum(part, jnp.int32(1 << 23))
    n_q = jnp.sum(part, axis=1).astype(jnp.int32)
    return (n_q,)


@functools.partial(jax.jit, static_argnames=("kb", "mcrop"))
def _count_expanded_sharded(ih_stack, bnd_ck, qh, qcnt, n_slots,
                            mid_occ, *, kb, mcrop=None):
    """_count_expanded over the hash-range shard stack: queries route
    by their top hash bits and search the virtual ck order; left comes
    back as a FLAT stack position (the step's anchor gathers decompose
    it as (flat >> lgNs, flat & (Ns-1))). mcrop as in _count_expanded
    (the i64 virtual-key sweeps are ~2x the 1-shard cost, so the crop
    matters even more here)."""
    S, Ns = ih_stack.shape
    lgS = S.bit_length() - 1
    Q, M = qh.shape
    mc = M if mcrop is None else min(mcrop, M)
    qh_c = qh[:, :mc]
    qcnt_c = qcnt[:, :mc]
    slot_on = jnp.arange(mc, dtype=jnp.int32)[None, :] < n_slots[:, None]
    qs = jnp.where(slot_on, qh_c, 0).astype(jnp.int64)
    sq = jnp.right_shift(qs, kb - lgS)
    qck = (sq << kb) + qs
    lr = _ss_ck(ih_stack, bnd_ck,
                jnp.concatenate([qck, qck + 1], axis=1), kb=kb)
    left = lr[:, :mc]
    occ = lr[:, mc:] - left
    out = _count_tail(occ, qcnt_c, slot_on, mid_occ)
    if mc < M:
        pad = ((0, 0), (0, M - mc))
        left = jnp.pad(left, pad)
        occ = jnp.pad(occ, pad)
    return out + (left, occ)


# ---------------------------------------------------------------------------
# the per-(part, group) programs


def _geom_ok(a, total, st: StepStatic):
    """Evaluation of numpy's `a >= total * min_ratio` under f64
    semantics (both sides promote to f64 — exact for values < 2^31; the
    product rounds to nearest-even).

    For a dyadic ratio p/2^s with s <= 53 (0.4 and every other standard
    ratio) the test `f64(a) >= RN(total*p/2^s)` is EXACTLY equivalent to
    the integer comparison  total*p53 <= a*2^53 + 2^ilog2(a)  with
    p53 = p << (53-s): the RHS is (a + ulp(a)/2)*2^53, and a's f64
    mantissa is always even for a < 2^52, so a midpoint tie rounds down
    to a. Evaluated overflow-free in 27-bit limbs. Larger scales
    (nonstandard tiny ratios) keep an approximate path that flags
    near-boundary chains for the exact host fallback.
    """
    a64 = jnp.maximum(a.astype(jnp.int64), 1)
    t64 = total.astype(jnp.int64)
    M27 = (1 << 27) - 1
    if st.p_s <= 53:
        p53 = (st.p_hi * (1 << 27) + st.p_lo) << (53 - st.p_s)
        p_hi, p_lo = p53 >> 27, p53 & M27
        low = t64 * p_lo
        P_hi = t64 * p_hi + (low >> 27)
        P_lo = low & M27
        # exact floor(log2(a)): f32 exponent field, corrected
        e0 = (jax.lax.shift_right_logical(
            jax.lax.bitcast_convert_type(a64.astype(jnp.float32),
                                         jnp.int32),
            np.int32(23)) - 127).astype(jnp.int64)
        pw = jax.lax.shift_left(jnp.int64(1), jnp.clip(e0, 0, 62))
        e = jnp.where(a64 < pw, e0 - 1,
                      jnp.where(a64 >= (pw << 1), e0 + 1, e0))
        T_hi = (a64 << 26) + jnp.where(
            e >= 27, jax.lax.shift_left(jnp.int64(1),
                                        jnp.clip(e - 27, 0, 62)), 0)
        T_lo = jnp.where(e < 27,
                         jax.lax.shift_left(jnp.int64(1),
                                            jnp.clip(e, 0, 26)), 0)
        ok = (P_hi < T_hi) | ((P_hi == T_hi) & (P_lo <= T_lo))
        return ok, jnp.zeros_like(ok)
    if st.p_s <= 80:
        # 53 < s <= 80: compare t*p <= (a*2^53 + 2^e) * 2^(s-53) in
        # three 27-bit limbs with borrow (same midpoint/tie reasoning)
        sh = st.p_s - 53
        M27 = (1 << 27) - 1
        p = st.p_hi * (1 << 27) + st.p_lo
        p1, p0 = p >> 27, p & M27
        low = t64 * p0
        x0 = low & M27
        mid = t64 * p1 + (low >> 27)
        x1 = mid & M27
        x2 = mid >> 27
        e0 = (jax.lax.shift_right_logical(
            jax.lax.bitcast_convert_type(a64.astype(jnp.float32),
                                         jnp.int32),
            np.int32(23)) - 127).astype(jnp.int64)
        pw = jax.lax.shift_left(jnp.int64(1), jnp.clip(e0, 0, 62))
        e = jnp.where(a64 < pw, e0 - 1,
                      jnp.where(a64 >= (pw << 1), e0 + 1, e0))
        b = e + sh  # bit position of the half-ulp term, <= 57
        one = jnp.int64(1)
        s0 = jnp.where(b < 27, jax.lax.shift_left(one, jnp.clip(b, 0, 26)),
                       0)
        s1 = jnp.where((b >= 27) & (b < 54),
                       jax.lax.shift_left(one, jnp.clip(b - 27, 0, 26)), 0)
        s2 = jnp.where(b >= 54,
                       jax.lax.shift_left(one, jnp.clip(b - 54, 0, 26)), 0)
        r0 = x0 - s0
        bor0 = (r0 < 0).astype(jnp.int64)
        r0 = r0 + (bor0 << 27)
        r1 = x1 - s1 - bor0
        bor1 = (r1 < 0).astype(jnp.int64)
        r1 = r1 + (bor1 << 27)
        r2 = x2 - s2 - bor1
        v2 = a64 << (sh - 1)  # a * 2^(53+sh) at the 2^54 limb scale
        ok = (r2 < 0) | (r2 < v2) | \
            ((r2 == v2) & (r1 == 0) & (r0 == 0))
        return ok, jnp.zeros_like(ok)
    # s > 80 would mean min_ratio < 2^-27; flag every chain so the host
    # fallback computes the row exactly — never hit by sane configs
    ok = jnp.ones_like(a64 > 0)
    return ok, jnp.ones_like(ok)


def _collect_anchors(irid, ips, rid_rank, mid_occ,
                     left_slot, occ_slot, qps, qcnt, n_slots, qlen,
                     qrank, qbisect, st: StepStatic, qspan=None):
    """Seed lookup, kept-minimizer accounting and sorted anchor
    expansion (lqmap.c:140-205). left_slot/occ_slot: the per-slot
    seed-lookup tables from _count_expanded (the searchsorted pair
    runs once per (part, group), in the count program). qps packs the
    per-slot minimizer (position << 1 | strand); qcnt the duplicate
    emission multiplicity. qspan: per-slot query minimizer spans (HPC
    mode; None = constant-span plain mode, span == k).

    Duplicate emissions of a slot share (hash, pos, strand, span) and
    the kept rank of their FIRST entry, so their anchors are
    bit-identical — the expansion therefore runs in ONE stage, slot ->
    qcnt*occ anchors, instead of round-4's slot -> M2 duplicate
    entries -> anchors (which paid ~6 extra (Q, M2) gathers per call).
    Exactness is
    unchanged: identical anchors are interchangeable under the stable
    (key1, key2) sort (see the module docstring's tie argument).

    Returns (key1, key2, yq, span_s, n_anch, n_q, n_kept, kept_ssum,
    anch_ssum); span_s/kept_ssum/anch_ssum are None in plain mode."""
    Q = left_slot.shape[0]
    M, A = st.M, st.A
    k32 = jnp.int32(st.k)

    # --- kept-minimizer accounting (lqmap.c:140-205)
    slot_on = jnp.arange(M, dtype=jnp.int32)[None, :] < n_slots[:, None]
    kept = slot_on & (occ_slot < mid_occ)
    kc = jnp.where(kept, qcnt, 0)
    kcum = jnp.cumsum(kc, axis=1)
    js_slot = kcum - kc            # kept rank of the slot's 1st entry
    n_kept = kcum[:, -1].astype(jnp.int32)
    kept_ssum = None
    if qspan is not None:
        kept_ssum = jnp.sum(jnp.where(kept, qcnt * qspan, 0),
                            axis=1).astype(jnp.int32)

    # --- weighted anchor expansion: slot j owns qcnt*occ anchors. The
    # owning slot of an anchor (searchsorted(ce, a, "right") in the
    # spec) is materialized by seeding each slot id at its run start
    # and forward-max-scanning instead of a vmapped binary search (a
    # while loop per anchor). The cumsum rides int64
    # (a repeat-heavy row's raw total can pass 2^31; the clamped int32
    # view keeps n_q monotone, and any row whose count exceeds the top
    # anchor rung was already forced off-device by the count pass).
    w = jnp.where(kept, qcnt * occ_slot, 0)
    ce = jnp.minimum(jnp.cumsum(w.astype(jnp.int64), axis=1),
                     np.int64(1 << 30)).astype(jnp.int32)
    n_q = ce[:, -1]
    a_ids = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32)[None, :],
                             (Q, A))
    ce_pad = jnp.concatenate([jnp.zeros((Q, 1), jnp.int32), ce], axis=1)
    starts_s = ce_pad[:, :M]           # run start offset of slot j
    s_ids = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[None, :],
                             (Q, M))
    rows_qm = jax.lax.broadcasted_iota(jnp.int32, (Q, M), 0)
    seed = jnp.full((Q, A), -1, jnp.int32).at[
        rows_qm, jnp.where(kept & (w > 0),
                           jnp.minimum(starts_s, A), A)].max(
        s_ids, mode="drop")
    e_of_a = jax.lax.associative_scan(jnp.maximum, seed, axis=1)
    t_in_s = a_ids - jnp.take_along_axis(ce_pad, e_of_a, axis=1)
    valid_a = a_ids < n_q[:, None]
    e_clip = jnp.clip(e_of_a, 0, M - 1)

    occ_a = jnp.take_along_axis(occ_slot, e_clip, axis=1)
    left_a = jnp.take_along_axis(left_slot, e_clip, axis=1)
    qps_a = jnp.take_along_axis(qps, e_clip, axis=1)
    js_a0 = jnp.take_along_axis(js_slot, e_clip, axis=1)
    # the t-th anchor of a slot reads index occurrence t mod occ
    # (duplicate entries' anchor sets are identical — order free); a
    # key's slot run is contiguous within one hash-range shard, so the
    # flat left positions work identically on the sharded stack
    idx_run = t_in_s % jnp.maximum(occ_a, 1)
    if irid.ndim == 2:
        Sn, Ns = irid.shape
        lgN = Ns.bit_length() - 1
        slot = jnp.clip(left_a + idx_run, 0, Sn * Ns - 1)
        rid_a = irid[slot >> lgN, slot & (Ns - 1)]
        ps_a = ips[slot >> lgN, slot & (Ns - 1)]
    else:
        N = irid.shape[0]
        slot = jnp.clip(left_a + idx_run, 0, N - 1)
        rid_a = irid[slot]
        ps_a = ips[slot]
    rpos = ps_a >> 1
    rstrand = ps_a & 1
    qpos_a = qps_a >> 1
    qstr_a = qps_a & 1
    fwd = rstrand == qstr_a
    rev = jnp.where(fwd, 0, 1)

    # NO_SELF / AVA suppression (lqmap.c:162-183)
    rrank = rid_rank[jnp.clip(rid_a, 0, rid_rank.shape[0] - 1)]
    drop = (rrank == qrank[:, None]) & (rpos == qpos_a)
    if st.ava:
        drop = drop | (rrank < qbisect[:, None])
    live = valid_a & ~drop
    key1 = jnp.where(live, (rev << 24) | rid_a, INF32)
    key2 = jnp.where(live, rpos, INF32)
    js_a = jnp.where(live, js_a0, 0)
    if qspan is None:
        span_a = anch_ssum = None
        yq = jnp.where(fwd, qpos_a,
                       qlen[:, None] - (qpos_a + 1 - k32) - 1)
        yq = jnp.where(live, yq, 0)
    else:
        span_a = jnp.take_along_axis(qspan, e_clip, axis=1)
        yq = jnp.where(fwd, qpos_a,
                       qlen[:, None] - (qpos_a + 1 - span_a) - 1)
        yq = jnp.where(live, yq, 0)
        span_a = jnp.where(live, span_a, 0)
        anch_ssum = jnp.sum(span_a, axis=1).astype(jnp.int32)
    n_anch = jnp.sum(live, axis=1).astype(jnp.int32)

    if qspan is None:
        key1, key2, yq, js_s = jax.lax.sort(
            (key1, key2, yq, js_a), dimension=1, num_keys=2,
            is_stable=True)
        span_s = None
    else:
        key1, key2, yq, js_s, span_s = jax.lax.sort(
            (key1, key2, yq, js_a, span_a), dimension=1, num_keys=2,
            is_stable=True)
    return (key1, key2, yq, js_s, span_s, n_anch, n_q, n_kept,
            kept_ssum, anch_ssum)


def _run_dp(key1, key2, yq, span_s, n_anch, limbs, rbad,
            st: StepStatic):
    """Chain-DP fill + peak ring pass (ops/chain_ring, route st.chain).
    limbs: (5, Q) int32 fixed-point gap multiplier limbs per row; rbad:
    (Q,) rows with no exact multiplier (flagged into the kernel flag).
    Ring depth comes from st.jring: 64 in steady state, 512 for the
    F_KERNEL escalation retry (rows whose predecessor window outruns
    64)."""
    Q, A = key1.shape
    kspan = jnp.full((Q, A), st.k, jnp.int32) if span_s is None \
        else span_s
    f, p, v, *rest = chain_fill(
        key1, key2, yq, kspan, n_anch, limbs, rbad,
        make_ring_carry(Q, st.jring), 0, J=st.jring,
        max_dist=st.max_gap, bw=st.bw, max_skip=st.max_skip,
        impl=st.chain)
    kflag = rest[-1].reshape(-1) != 0
    peak = peak_pass(f, v, p, J=st.jring, impl=st.chain)
    return f, p, v, peak, kflag


def _post_dp(key1, key2, yq, js_s, span_s, f, p, v, peak, kflag,
             n_anch, n_q, n_kept, seq_lens, qlen, qvalid,
             n_exp, lam, lam2, avgk_set, m_cnts, st: StepStatic):
    """Chain selection, reg geometry, coverage accounting and interval
    compression (chain extraction per ops/chainsel; esterr.c:72-140;
    lqmap.c:25-100). span_s: per-anchor spans in sorted order (None =
    plain mode, span == k)."""
    Q, A = key1.shape
    M2 = st.M2
    rows = jax.lax.broadcasted_iota(jnp.int32, (Q, A), 0)
    k32 = jnp.int32(st.k)
    a_ids = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32)[None, :],
                             (Q, A))

    # --- chain candidates: ends -> unique peaks -> ranks (chainsel)
    anch_on = a_ids < n_anch[:, None]
    # an anchor is a parent iff some anchor's predecessor pointer names
    # it: one scatter (parents are < J behind, so p in [-1, A))
    child_on = (p >= 0) & anch_on
    is_parent = jnp.zeros((Q, A + 1), jnp.int32).at[
        rows, jnp.where(child_on, p, A)].max(
        child_on.astype(jnp.int32), mode="drop")[:, :A] > 0
    endm = anch_on & ~is_parent & (v >= st.min_sc)
    MAXI = jnp.int32(0x3FFFFFFF)
    ek1 = jnp.where(endm, MAXI - v, INF32)
    ek2 = jnp.where(endm, MAXI - peak, INF32)
    ek1, ek2 = jax.lax.sort((ek1, ek2), dimension=1, num_keys=2,
                            is_stable=False)
    it_valid = ek1 != INF32
    prev1 = jnp.pad(ek1, ((0, 0), (1, 0)), constant_values=-1)[:, :A]
    prev2 = jnp.pad(ek2, ((0, 0), (1, 0)), constant_values=-1)[:, :A]
    is_new = it_valid & ((ek1 != prev1) | (ek2 != prev2))
    rank_it = jnp.cumsum(is_new, axis=1).astype(jnp.int32) - 1
    peak_it = jnp.where(is_new, MAXI - ek2, A)
    own = jnp.full((Q, A), INF32, jnp.int32)
    own = own.at[rows, jnp.clip(peak_it, 0, A)].min(
        jnp.where(is_new, rank_it, INF32), mode="drop")

    mr = minrank_pass(p, own, J=st.jring, impl=st.chain)
    mr = jnp.where(anch_on, mr, INF32)

    # --- segment chains in (min-rank, idx) order; stable sort keeps idx
    # ascending within a rank, so run start = root-most anchor and run
    # end = peak
    smr, sidx = jax.lax.sort(
        (mr, a_ids), dimension=1, num_keys=1, is_stable=True)
    s_valid = smr != INF32
    prev_mr = jnp.pad(smr, ((0, 0), (1, 0)), constant_values=-1)[:, :A]
    is_b = s_valid & (smr != prev_mr)
    next_mr = jnp.pad(smr, ((0, 0), (0, 1)), constant_values=-1)[:, 1:]
    is_last = s_valid & (smr != next_mr)
    spos = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32)[None, :],
                            (Q, A))
    first_pos = _seg_fill_last(is_b, spos, 0)
    first_idx = _seg_fill_last(is_b, sidx, 0)
    cnt = spos - first_pos + 1
    # chain records live at is_last slots
    pk_idx = sidx
    score = jnp.take_along_axis(f, jnp.clip(pk_idx, 0, A - 1), axis=1)
    stop = jnp.take_along_axis(p, jnp.clip(first_idx, 0, A - 1), axis=1)
    f_stop = jnp.take_along_axis(f, jnp.clip(stop, 0, A - 1), axis=1)
    score0 = jnp.where(stop >= 0, score - f_stop, score)
    accept = is_last & (cnt >= st.min_cnt) & \
        ((stop < 0) | (score0 >= st.min_sc))

    # --- reg coordinates (hit.c:23-38 mm_reg_set_coor)
    def gat(arr, idx):
        return jnp.take_along_axis(arr, jnp.clip(idx, 0, A - 1), axis=1)

    k1_f = gat(key1, first_idx)
    c_rev = (k1_f >> 24) & 1
    c_rid = k1_f & ((1 << 24) - 1)
    rs_last = gat(key2, first_idx)
    yq0 = gat(yq, first_idx)
    re = gat(key2, pk_idx) + 1
    yql = gat(yq, pk_idx)
    # span of the chain's root-most anchor (q_span in chain_to_reg,
    # overlap_host); constant k in plain mode
    span_f = k32 if span_s is None else gat(span_s, first_idx)
    rs = jnp.maximum(rs_last + 1 - span_f, 0)
    qlen_b = qlen[:, None]
    qs = jnp.where(c_rev == 0, yq0 + 1 - span_f, qlen_b - (yql + 1))
    qe = jnp.where(c_rev == 0, yql + 1, qlen_b - (yq0 + 1 - span_f))

    # --- lq_cnt_match (esterr.c:72-140)
    capped = avgk_set.astype(bool) & \
        ((lam // jnp.maximum(qlen.astype(jnp.int64), 1)) > st.covt)
    proc = qvalid.astype(bool) & (n_kept > 0) & ~capped

    # searchsorted(mp_pos, x0) of the chain's first forward anchor is
    # its precomputed kept rank (js_s); the rank is in range and its
    # mp_pos entry matches by construction, so ok_st is always true for
    # a real chain (host ok_st only guards non-anchor x0 values)
    first_fwd = jnp.where(c_rev == 0, first_idx, pk_idx)
    st_c = jnp.clip(gat(js_s, first_fwd), 0, M2 - 1)

    rl = seq_lens[jnp.clip(c_rid, 0, seq_lens.shape[0] - 1)]
    hang5 = jnp.minimum(qs, rs)
    hang3 = jnp.minimum(qlen_b - qe, rl - re)
    span_q = qe - qs
    total = span_q + hang5 + hang3
    g_ok, g_near = _geom_ok(span_q, total, st)
    geom = g_ok & (hang5 <= st.max_overhang) & (hang3 <= st.max_overhang)
    ok = accept & geom & proc[:, None]
    flag_geom = jnp.any(accept & g_near & proc[:, None], axis=1)

    dlen = (qe - qs + 1).astype(jnp.int64)
    lam_new = lam + jnp.sum(jnp.where(ok, dlen, 0), axis=1)
    med = score0 >= st.min_sc_m
    good = ok & (score0 >= st.min_sc_g)
    lam2_new = lam2 + jnp.sum(jnp.where(good, dlen, 0), axis=1)
    avgk_new = jnp.where(proc & (n_kept > 0), 1, avgk_set)

    # m_cnts: st hit per good chain, then one hit per chained anchor
    # excluding the forward-first anchor (esterr.c:120-138)
    mc = m_cnts.at[rows, jnp.where(good, st_c, M2)].add(
        jnp.where(good, 1, 0), mode="drop")
    # per-anchor chain tables indexed by rank
    rank_at_last = jnp.where(is_last, smr, A)
    tbl_good = jnp.zeros((Q, A), jnp.int32).at[
        rows, jnp.clip(rank_at_last, 0, A)].max(
        jnp.where(good, 1, 0), mode="drop")
    tbl_ff = jnp.full((Q, A), -1, jnp.int32).at[
        rows, jnp.clip(rank_at_last, 0, A)].max(
        jnp.where(is_last, first_fwd, -1), mode="drop")
    mr_c = jnp.clip(mr, 0, A - 1)
    a_good = (mr != INF32) & \
        (jnp.take_along_axis(tbl_good, mr_c, axis=1) == 1)
    a_first = jnp.take_along_axis(tbl_ff, mr_c, axis=1) == a_ids
    # per-anchor searchsorted(mp_pos, fq) == the anchor's kept rank
    # (fq is the anchor's own minimizer position on both strands)
    js_c = jnp.clip(js_s, 0, M2 - 1)
    walk = a_good & ~a_first & anch_on
    mc = mc.at[rows, jnp.where(walk, js_c, M2)].add(
        jnp.where(walk, 1, 0), mode="drop")
    flag_sat = jnp.max(mc, axis=1) >= 65535

    # --- interval compression (filter_redundant_coords, lqmap.c:25-100)
    ev_s = (qs << 3) | jnp.where(med, 2, 0)
    ev_e = (qe << 3) | jnp.where(med, 3, 1)
    cv_key = jnp.where(ok, spos, INF32)
    _, (cv_s, cv_e), n_cv = _compact_rows(cv_key, (ev_s, ev_e), CV, INF32)
    cv_on = jnp.arange(CV, dtype=jnp.int32)[None, :] < \
        jnp.minimum(n_cv, CV)[:, None]
    flag_cv = n_cv > CV
    cv_s = jnp.where(cv_on, cv_s, INF32)
    cv_e = jnp.where(cv_on, cv_e, INF32)

    vc = jnp.sort(jnp.concatenate([cv_s, cv_e], axis=1), axis=1)
    vc_on = vc != INF32
    delta = jnp.where(vc_on & ((vc & 2) != 0),
                      jnp.where((vc & 1) != 0, -1, 1), 0)
    medc = jnp.cumsum(delta, axis=1)
    prevc = medc - delta
    up = vc_on & (prevc < st.min_cov) & (medc >= st.min_cov)
    down = vc_on & (prevc >= st.min_cov) & (medc < st.min_cov)
    med_start = _seg_fill_last(up, vc, 0)
    mlen_nz = ((vc >> 3) - med_start) != 0
    is_mc = down & mlen_nz
    ms_c, (me_c,), n_mc = _compact_rows(
        jnp.where(is_mc, med_start, INF32), (vc,), CV, INF32)
    mc_on = jnp.arange(CV, dtype=jnp.int32)[None, :] < \
        jnp.minimum(n_mc, CV)[:, None]
    ms_c = jnp.where(mc_on, ms_c, INF32)
    me_c = jnp.where(mc_on, me_c, 0)
    # searchsorted-right by compare-sum: rows are CV=512 wide, so the
    # (Q, CV, CV) compare-reduce is ~34M dense ops, where a vmapped
    # binary search is a while loop
    ri = jnp.sum((ms_c[:, None, :] <= cv_s[:, :, None]).astype(
        jnp.int32), axis=2) - 1
    ri_c = jnp.clip(ri, 0, CV - 1)
    contained = (ri >= 0) & \
        (cv_e <= jnp.take_along_axis(me_c, ri_c, axis=1)) & \
        (cv_s >= jnp.take_along_axis(ms_c, ri_c, axis=1))
    keep_iv = cv_on & ~contained

    cand = jnp.concatenate([
        jnp.where(keep_iv, cv_s, INF32),
        jnp.where(keep_iv, cv_e, INF32),
        jnp.where(mc_on, ms_c | 4, INF32),
        jnp.where(mc_on, me_c | 4, INF32)], axis=1)
    events, _, ev_n = _compact_rows(cand, (), EOUT, INF32)

    # --- commit (flagged rows keep their old state)
    new_flags = (jnp.where(kflag, F_KERNEL, 0)
                 | jnp.where(flag_sat, F_SAT, 0)
                 | jnp.where(flag_cv, F_CV, 0)
                 | jnp.where(flag_geom, F_GEOM, 0)
                 | jnp.where(n_q > A, F_ANCH, 0)
                 | jnp.where(n_exp > M2, F_EXP, 0)).astype(jnp.int32)
    new_flags = jnp.where(qvalid.astype(bool), new_flags, 0)
    bad = new_flags != 0
    lam_new = jnp.where(bad, lam, lam_new)
    lam2_new = jnp.where(bad, lam2, lam2_new)
    avgk_new = jnp.where(bad, avgk_set, avgk_new)
    mc = jnp.where(bad[:, None], m_cnts, mc)
    ev_n = jnp.where(bad | ~proc, 0, jnp.minimum(ev_n, EOUT)) \
        .astype(jnp.int32)
    # single packed pull target per call: [flags | ev_n | compacted
    # events]. Events compact ACROSS rows (grouped by row id with one
    # flat sort; per-row order is irrelevant — finalize sorts each
    # read's endpoint multiset) into a fixed EV_B budget, so the pull
    # is ~40 KB instead of the (Q, EOUT) ~1 MB of mostly padding.
    # sum(ev_n) > EV_B (extreme event
    # volume) makes the caller pull the uncompacted events_full once.
    rows_e = jax.lax.broadcasted_iota(jnp.int32, (Q, EOUT), 0)
    cols_e = jax.lax.broadcasted_iota(jnp.int32, (Q, EOUT), 1)
    ev_on = cols_e < ev_n[:, None]
    rk = jnp.where(ev_on, rows_e, INF32).reshape(-1)
    vv = jnp.where(ev_on, events, 0).reshape(-1)
    _rk_s, vv_s = jax.lax.sort((rk, vv), dimension=0, num_keys=1,
                               is_stable=False)
    packed_small = jnp.concatenate([new_flags, ev_n, vv_s[:EV_B]])
    return (lam_new, lam2_new, avgk_new, mc, packed_small, events,
            proc, new_flags)


def _step_impl(irid, ips, seq_lens, rid_rank, mid_occ,
               left_slot, occ_slot, qps, qcnt, n_slots, n_exp, qlen,
               qrank, qbisect, qvalid, lam, lam2, avgk_set, m_cnts,
               limbs5, st: StepStatic):
    """One (part x query-group) update (plain sketch, constant span).
    Returns committed state, the packed [flags|ev_n|compact events]
    pull target, and the uncompacted (Q, EOUT) events (pulled only on
    EV_B overflow). left_slot/occ_slot come from the count pass.

    Q is taken from the runtime shape (not st.Q) so the same body serves
    both the single-device jit and the shard_map lane-sharded wrapper
    (parallel/mesh.overlap P8 scaling: index replicated, lanes sharded).
    """
    Q = left_slot.shape[0]
    (key1, key2, yq, js_s, _sp, n_anch, n_q, n_kept,
     _ks, _as) = _collect_anchors(
        irid, ips, rid_rank, mid_occ, left_slot, occ_slot, qps,
        qcnt, n_slots, qlen, qrank, qbisect, st)
    limbs = jnp.broadcast_to(limbs5[:, None], (5, Q))
    rbad = jnp.zeros((Q,), jnp.int32)
    f, p, v, peak, kflag = _run_dp(key1, key2, yq, None, n_anch,
                                   limbs, rbad, st)
    out = _post_dp(key1, key2, yq, js_s, None, f, p, v, peak, kflag,
                   n_anch, n_q, n_kept, seq_lens, qlen, qvalid,
                   n_exp, lam, lam2, avgk_set, m_cnts, st)
    return out[:6]


_step = functools.partial(jax.jit, static_argnames=("st",),
                          donate_argnames=("lam", "lam2", "avgk_set",
                                           "m_cnts"))(_step_impl)


@functools.partial(jax.jit, static_argnames=("st",))
def _step_hpc_a(irid, ips, rid_rank, mid_occ, left_slot, occ_slot,
                qps, qcnt, n_slots, qspan, qlen, qrank, qbisect,
                st: StepStatic):
    """HPC step, phase A: anchors + spans + the per-row span statistics
    the host needs to fit the per-row gap-penalty multiplier
    (avg_qspan is data-dependent under HPC, sketch.c:90-104). Returns
    device arrays for phase B plus a (Q, 5) stats pull target
    [n_anch, anch_span_sum, n_kept, kept_span_sum, n_q]."""
    (key1, key2, yq, js_s, span_s, n_anch, n_q, n_kept,
     kept_ssum, anch_ssum) = _collect_anchors(
        irid, ips, rid_rank, mid_occ, left_slot, occ_slot, qps,
        qcnt, n_slots, qlen, qrank, qbisect, st, qspan=qspan)
    stats = jnp.stack([n_anch, anch_ssum, n_kept, kept_ssum, n_q],
                      axis=1)
    return (key1, key2, yq, js_s, span_s, n_anch, n_q, n_kept,
            stats)


@functools.partial(jax.jit, static_argnames=("st",),
                   donate_argnames=("lam", "lam2", "avgk_set",
                                    "avgk_val", "m_cnts"))
def _step_hpc_b(key1, key2, yq, js_s, span_s, n_anch, n_q,
                n_kept, seq_lens, qlen, qvalid, n_exp, lam, lam2,
                avgk_set, avgk_val, m_cnts, limbs, rbad, kept_avg,
                st: StepStatic):
    """HPC step, phase B: chain DP + accounting with per-anchor spans
    and per-row penalty limbs. avgk_val (f32 state) captures the kept-
    minimizer mean span the first time a row is processed (the host
    spec's state.avg_k, set host-side in kept_avg for f32 bit parity)."""
    f, p, v, peak, kflag = _run_dp(key1, key2, yq, span_s, n_anch,
                                   limbs, rbad, st)
    (lam_n, lam2_n, avgk_n, mc, packed_small, events_full, proc,
     new_flags) = _post_dp(
        key1, key2, yq, js_s, span_s, f, p, v, peak, kflag, n_anch,
        n_q, n_kept, seq_lens, qlen, qvalid, n_exp, lam, lam2,
        avgk_set, m_cnts, st)
    bad = new_flags != 0
    set_now = proc & (n_kept > 0) & (avgk_set == 0) & ~bad
    avgk_val_n = jnp.where(set_now, kept_avg, avgk_val)
    return (lam_n, lam2_n, avgk_n, avgk_val_n, mc, packed_small,
            events_full)


@functools.partial(jax.jit, static_argnames=("M",))
def _compact_sketch_hpc(emit, hsh, pos, strand, *, M):
    """Per-row compaction of the HPC sketch output (u64 packed keys
    hash<<8|span) into (hash32, pos, strand, span) i32 slots."""
    B, L = emit.shape
    has = emit > 0
    posl = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :],
                            (B, L))
    order = jnp.argsort(jnp.where(has, posl, INF32), axis=1)[:, :M]
    n = jnp.sum(has, axis=1).astype(jnp.int32)
    slot_on = jnp.arange(M, dtype=jnp.int32)[None, :] < \
        jnp.minimum(n, M)[:, None]
    pk = jnp.take_along_axis(hsh, order, axis=1)
    qh = jnp.where(slot_on,
                   (pk >> jnp.uint64(8)).astype(jnp.uint32)
                   .astype(jnp.int32), INF32)
    qspan = jnp.where(slot_on,
                      (pk & jnp.uint64(0xFF)).astype(jnp.int32), 0)
    qpos = jnp.where(slot_on,
                     jnp.take_along_axis(pos.astype(jnp.int32), order,
                                         axis=1), 0)
    qstrand = jnp.where(slot_on,
                        jnp.take_along_axis(strand.astype(jnp.int32),
                                            order, axis=1), 0)
    qcnt = jnp.where(slot_on,
                     jnp.take_along_axis(emit.astype(jnp.int32), order,
                                         axis=1), 0)
    return qh, qpos, qstrand, qspan, qcnt, n


@functools.lru_cache(maxsize=64)
def _sharded_step(mesh, st: StepStatic):
    """Lane-sharded _step over a device mesh: the part index (and limbs)
    ride replicated; every per-lane array is split over the data axis.
    No collectives are needed inside — per-read accumulators are
    shard-local by construction (minimap2-coverage.c:434-444 ownership
    model) and only merge at finalize on host."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rep = P()
    lane1 = P("data")
    lane2 = P("data", None)
    in_specs = (rep, rep, rep, rep, rep,               # index
                lane2, lane2, lane2, lane2,            # left..qcnt
                lane1, lane1, lane1, lane1, lane1,     # n_slots..qbisect
                lane1, lane1, lane1, lane1,            # qvalid + state
                lane2, rep)                            # m_cnts, limbs
    # packed_small is per-shard [flags|ev_n|events]: shards concatenate
    # along axis 0, so the host unpacker walks per-shard blocks
    out_specs = (lane1, lane1, lane1, lane2, lane1, lane2)
    fn = shard_map(functools.partial(_step_impl, st=st), mesh=mesh,
                   in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return jax.jit(fn)


@jax.jit
def _finalize_group(lam, lam2, m_cnts, n_exp):
    """Per-row div-statistics inputs (minimap2-coverage.c:545-563):
    uint32-wrapped m_cnts sum, integer-divided by the full minimizer
    count, then the above-mean match count."""
    wrapped = jnp.sum(m_cnts.astype(jnp.int64), axis=1) % (1 << 32)
    mv_n = jnp.maximum(n_exp.astype(jnp.int64), 1)
    ssum = wrapped // mv_n
    n_match = jnp.sum(m_cnts.astype(jnp.int64) > ssum[:, None], axis=1)
    return (lam.astype(jnp.int64), lam2.astype(jnp.int64),
            n_match.astype(jnp.int32), ssum.astype(jnp.int32))


@functools.partial(
    jax.jit, donate_argnames=("lam", "lam2", "avgk_set", "m_cnts"))
def _apply_fix(lam, lam2, avgk_set, m_cnts, mask,
               lam_fix, lam2_fix, avgk_fix, m_fix):
    mb = mask.astype(bool)
    return (jnp.where(mb, lam_fix, lam),
            jnp.where(mb, lam2_fix, lam2),
            jnp.where(mb, avgk_fix, avgk_set),
            jnp.where(mb[:, None], m_fix, m_cnts))


@functools.partial(jax.jit, static_argnames=("M", "M2", "n_real"))
def _group_valid(n_slots, n_exp, *, M, M2, n_real):
    """Device-side row validity: rows whose sketch compaction or
    expansion overflowed are invalid (host-processed); padding lanes
    are invalid. Avoids any host pull during engine construction.

    Also returns the max slot count over valid rows (ns_max): the
    count pass's search-width rung selector (_run_part picks the
    smallest crop in {M/4, M/2, M} >= ns_max; invalid rows never ride
    the device path, so their slot counts don't constrain the crop)."""
    lane = jnp.arange(n_slots.shape[0], dtype=jnp.int32)
    ovf = (n_slots > M) | (n_exp > M2)
    valid = (~ovf) & (lane < n_real)
    ns_max = jnp.max(jnp.where(valid, n_slots, 0)).astype(jnp.int32)
    return valid.astype(jnp.int32), (ovf & (lane < n_real)), ns_max


@functools.partial(jax.jit, static_argnames=("M",))
def _compact_sketch(emit, hsh, pos, strand, *, M):
    """Per-row compaction of the sketch kernel's (B, L) output into the
    first M emitting slots (position order). u32 sketch hashes compact
    to i32 lanes; bare u64 wide hashes (2k > 30) to i64 lanes with the
    matching sentinel (the device index carries the same dtype)."""
    B, L = emit.shape
    has = emit > 0
    posl = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :],
                            (B, L))
    order = jnp.argsort(jnp.where(has, posl, INF32), axis=1)[:, :M]
    n = jnp.sum(has, axis=1).astype(jnp.int32)
    slot_on = jnp.arange(M, dtype=jnp.int32)[None, :] < \
        jnp.minimum(n, M)[:, None]
    if hsh.dtype == jnp.uint64:
        qh = jnp.take_along_axis(hsh.astype(jnp.int64), order, axis=1)
        qh = jnp.where(slot_on, qh, di.infk(np.int64))
    else:
        qh = jnp.take_along_axis(
            hsh.astype(jnp.uint32).astype(jnp.int32), order, axis=1)
        qh = jnp.where(slot_on, qh, INF32)
    qpos = jnp.where(slot_on,
                     jnp.take_along_axis(pos.astype(jnp.int32), order,
                                         axis=1), 0)
    qstrand = jnp.where(slot_on,
                        jnp.take_along_axis(strand.astype(jnp.int32),
                                            order, axis=1), 0)
    qcnt = jnp.where(slot_on,
                     jnp.take_along_axis(emit.astype(jnp.int32), order,
                                         axis=1), 0)
    return qh, qpos, qstrand, qcnt, n


def _make_static(cfg, lanes, M, M2, A, k, chain, jring=J):
    m = cfg.map
    f = cfg.flt
    p_hi, p_lo, p_s = _ratio_limbs(f.min_ratio)
    return StepStatic(
        Q=lanes, M=M, M2=M2, A=A, k=k,
        max_gap=m.max_gap, bw=m.bw, max_skip=m.max_chain_skip,
        min_cnt=m.min_cnt, min_sc=m.min_chain_score,
        min_sc_m=m.min_score_med, min_sc_g=m.min_score_good,
        max_overhang=f.max_overhang, min_cov=f.min_coverage,
        covt=cfg.covt, ava=cfg.ava,
        p_hi=p_hi, p_lo=p_lo, p_s=p_s, chain=chain,
        jring=jring)


def _len_bucket(n):
    b = 4096
    while b < n:
        b *= 4
    return b


class _Group:
    """A batch of query lanes sharing one length bucket (GROUP_Q lanes
    per mesh shard)."""

    def __init__(self, qids, reads, k, w, lanes=GROUP_Q, hpc=False):
        self.lanes = lanes
        self.qids = qids                     # lane -> global query index
        self.hpc = hpc
        self.blen = _len_bucket(max(len(reads[i][1]) for i in qids))
        self.M = self.blen // 2
        self.M2 = self.blen
        if hpc:
            # homopolymer-compressed entries (sketch.c:90-104): one
            # entry per run, positions = run-end read coordinate, spans
            # = windowed run-length sums. Compressed length <= read
            # length, so the original-length bucket always fits.
            from longqc_tpu.ops.sketch_hpc import hpc_compress
            comp = [hpc_compress(reads[i][1], k) for i in qids]
            while len(comp) < lanes:
                comp.append(hpc_compress("A" * k, k))
            codes = np.full((lanes, self.blen), 4, np.uint8)
            positions = np.zeros((lanes, self.blen), np.int32)
            spans = np.zeros((lanes, self.blen), np.int32)
            lengths = np.zeros(lanes, np.int32)
            for slot, (c, p, s) in enumerate(comp):
                codes[slot, :len(c)] = c
                positions[slot, :len(c)] = p
                spans[slot, :len(c)] = s
                lengths[slot] = len(c)
            res = sketch_batch(jnp.asarray(codes), jnp.asarray(lengths),
                               w=w, k=k,
                               positions=jnp.asarray(positions),
                               spans=jnp.asarray(spans))
            (self.qh, self.qpos, self.qstrand, self.qspan, qcnt,
             self.n_slots) = _compact_sketch_hpc(
                res["emit"], res["hash"], res["pos"], res["strand"],
                M=self.M)
        else:
            rows = [reads[i] for i in qids]
            while len(rows) < lanes:
                rows.append(["\0pad", "A" * k, ""])
            batch = pack_reads(rows, max_len=self.blen,
                               pad_to=self.blen, with_quals=False)
            res = sketch_batch(jnp.asarray(batch.codes),
                               jnp.asarray(batch.lengths), w=w, k=k)
            (self.qh, self.qpos, self.qstrand, qcnt,
             self.n_slots) = _compact_sketch(
                res["emit"], res["hash"], res["pos"], res["strand"],
                M=self.M)
            self.qspan = None
        self.qps, self.n_exp = _pack_group_slots(self.qpos,
                                                 self.qstrand, qcnt,
                                                 self.n_slots)
        self.qcnt = qcnt
        self.qlen = jnp.asarray(
            np.array([len(reads[i][1]) for i in qids]
                     + [0] * (lanes - len(qids)), np.int32))
        # validity computed on device — engine construction performs no
        # host pull
        self.qvalid, self._ovf_dev, self._ns_max_dev = _group_valid(
            self.n_slots, self.n_exp, M=self.M, M2=self.M2,
            n_real=len(qids))
        _async_pull(self._ovf_dev)
        _async_pull(self._ns_max_dev)
        self._perm_host = None
        self._ns_max = None
        # state
        self.lam = jnp.zeros((lanes,), jnp.int64)
        self.lam2 = jnp.zeros((lanes,), jnp.int64)
        self.avgk_set = jnp.zeros((lanes,), jnp.int32)
        self.avgk_val = jnp.zeros((lanes,), jnp.float32) if hpc else None
        self.m_cnts = jnp.zeros((lanes, self.M2), jnp.int32)
        self._host_sketch = None

    @property
    def perm_host(self):
        """(lanes,) bool: rows permanently host-processed (sketch
        compaction/expansion overflow — adversarial periodic reads).
        Resolved lazily on first host access, which happens after the
        first step results return (pulls are safe by then)."""
        if self._perm_host is None:
            self._perm_host = np.asarray(self._ovf_dev)
        return self._perm_host

    @property
    def ns_max(self):
        """Max slot count over this group's valid rows (host int; the
        staging pull is async, so realization is usually instant)."""
        if self._ns_max is None:
            self._ns_max = int(np.asarray(self._ns_max_dev))
        return self._ns_max

    def count_crop(self):
        """Search-width rung for the count pass: smallest of
        {M/4, M/2, M} that holds every valid row's slots."""
        for mc in (self.M // 4, self.M // 2):
            if mc >= 1 and self.ns_max <= mc:
                return mc
        return self.M

    def host_sketch_lists(self, k, w, reads):
        """Per-lane (hash, pos, strand, span) expanded lists for the
        host fallback (sketch_to_lists contract). Pulled lazily from the
        device compaction; rows whose compaction overflowed (perm_host)
        are re-sketched exactly via the host path."""
        if self._host_sketch is None:
            qh = np.asarray(self.qh)
            qpos = np.asarray(self.qpos)
            qstr = np.asarray(self.qstrand)
            qcnt = np.asarray(self.qcnt)
            ns = np.asarray(self.n_slots)
            qsp = np.asarray(self.qspan) if self.hpc else None
            out = []
            for r in range(self.lanes):
                if r < len(self.qids) and self.perm_host[r]:
                    if self.hpc:
                        from longqc_tpu.ops.sketch_hpc import \
                            sketch_reads_hpc
                        out.append(sketch_reads_hpc(
                            [reads[self.qids[r]]], k, w)[0])
                    else:
                        out.append(oh.sketch_reads_device(
                            [reads[self.qids[r]]], k, w)[0])
                    continue
                n = min(int(ns[r]), self.M)
                rep = np.repeat(np.arange(n), qcnt[r, :n])
                spans = (qsp[r, rep].astype(np.int64) if self.hpc
                         else np.full(len(rep), k, np.int64))
                out.append((qh[r, rep].astype(np.uint64),
                            qpos[r, rep].astype(np.int64),
                            qstr[r, rep].astype(np.int64),
                            spans))
            self._host_sketch = out
        return self._host_sketch


class _PartIndex:
    """Device-resident index over one target part + host-side metadata.

    The index itself comes from engine/device_index.build_device_index
    (canonical-shape tiles + merge-path combines); this wrapper adds the
    per-part host metadata (name ranks for AVA ordering, rid-indexed
    seq_lens at a canonical padding) and the lazy exact host index for
    the per-row fallback. On IndexOverflowError (extreme adversarial
    input) the part is marked host_only and every row is computed by the
    host spec for this part.
    """

    def __init__(self, part, k, w, mid_occ_fixed, mid_occ_frac,
                 ladder, n_idx_sizes, hpc=False):
        self.part = part
        self.names = [r[0] for r in part]
        uniq = sorted(set(self.names))
        self.name_rank = {n: i for i, n in enumerate(uniq)}
        self.sorted_names = uniq
        B = len(part)
        assert B < (1 << 24), "part read count exceeds rid packing"
        self.B_pad = next(b for b in B_PADS if B <= b)
        rid_rank = np.full(self.B_pad, -2, np.int32)
        rid_rank[:B] = [self.name_rank[n] for n in self.names]
        seq_lens = np.zeros(self.B_pad, np.int32)
        seq_lens[:B] = [len(r[1]) for r in part]
        self.rid_rank = jnp.asarray(rid_rank)
        self.seq_lens = jnp.asarray(seq_lens)
        self.host_only = False
        self.hpc = hpc
        self.n_shards = 1
        self.bnd_ck = None
        self.kb = 2 * k
        if hpc:
            # HPC targets (the spike-in control genome, longQC.py:255)
            # are tiny; the exact host index is built directly and
            # converted to the device layout (hash-major sorted arrays
            # with duplicates expanded — the same contract the tile
            # pipeline produces). k <= 15 keeps hashes in int32.
            hidx = oh.build_index(part, k, w, is_hpc=True)
            n_real = len(hidx.h)
            n_idx = next((s for s in n_idx_sizes if n_real <= s), None)
            if n_idx is None:
                self.host_only = True
                self.ih = self.irid = self.ips = None
                self.mid_occ = None
            else:
                ih = np.full(n_idx, INF32, np.int32)
                ih[:n_real] = hidx.h.astype(np.int64).astype(np.int32)
                irid = np.zeros(n_idx, np.int32)
                irid[:n_real] = hidx.rid.astype(np.int32)
                ips = np.zeros(n_idx, np.int32)
                ips[:n_real] = hidx.ps.astype(np.int32)
                self.ih = jnp.asarray(ih)
                self.irid = jnp.asarray(irid)
                self.ips = jnp.asarray(ips)
                mo = mid_occ_fixed or hidx.mid_occ(mid_occ_frac)
                self.mid_occ = jnp.asarray(np.int32(mo))
            self._host_index = hidx
            self._k, self._w = k, w
            return
        try:
            idx = di.build_device_index(
                part, k, w, ladder=ladder, n_idx_sizes=n_idx_sizes,
                mid_occ_fixed=mid_occ_fixed, mid_occ_frac=mid_occ_frac)
            self.ih = idx["ih"]
            self.irid = idx["irid"]
            self.ips = idx["ips"]
            self.mid_occ = idx["mid_occ"]
            self.n_shards = idx.get("n_shards", 1)
            self.bnd_ck = idx.get("bnd_ck")
            self.kb = idx.get("kb", 2 * k)
        except di.IndexOverflowError:
            logger.warning("device index overflow; part falls back to "
                           "the host path")
            self.host_only = True
            self.ih = self.irid = self.ips = None
            self.mid_occ = None
        self._host_index = None
        self._k, self._w = k, w

    def host_index(self):
        """Exact host MinimizerIndex for this part (built lazily, only
        when a flagged row needs the host fallback; the HPC path builds
        it eagerly as the device index source)."""
        if self._host_index is None:
            self._host_index = oh.build_index(self.part, self._k,
                                              self._w, is_hpc=self.hpc)
        return self._host_index


class DeviceOverlapEngine:
    """Device-resident overlap engine with exact per-row host fallback.

    Produces rows bit-identical to overlap_host.overlap_run (the
    executable spec of minimap2-coverage).
    """

    def __init__(self, cfg: OverlapConfig, query_reads, mesh=None,
                 lanes_per_shard=GROUP_Q):
        """mesh: optional jax.sharding.Mesh with a "data" axis. Query
        lanes are sharded over it and the part index rides replicated
        (the reference's only scale axis — per-read-owned accumulators,
        minimap2-coverage.c:434-444). Each shard gets lanes_per_shard
        lanes.

        The chain route and the tile / index geometry come from
        backend.decide(); the anchor rungs are A_BUCKETS.
        """
        self.wide = 2 * cfg.index.k > 30
        self.hpc = cfg.index.is_hpc
        if self.hpc and self.wide:
            # HPC packs hash<<8|span into i32 index lanes (k <= 15);
            # every reference HPC surface (spike-in filter, pb-hifi
            # main run) uses k = 15, so wide+HPC has no caller
            raise NotImplementedError("HPC device engine requires "
                                      "k <= 15")
        if self.hpc and mesh is not None:
            raise NotImplementedError(
                "HPC sketch is single-device (filter runs are small)")
        self.cfg = cfg
        self.k, self.w = cfg.index.k, cfg.index.w
        if self.hpc:
            # per-row gap multipliers are fitted from the data-dependent
            # avg_qspan between the two step phases (_step_hpc_a/_b)
            self.limbs5 = None
        else:
            limbs = penalty_limbs(float(np.float32(self.k)), cfg.map.bw)
            if limbs is None:
                raise NotImplementedError(
                    "no fixed-point gap-penalty multiplier for this "
                    "(k, bw)")
            self.limbs5 = jnp.asarray(limbs)
        be = backend.decide()
        self.chain = be.chain
        self.a_ladder = A_BUCKETS
        if be.geometry == "big":
            self.tile_ladder = di.TILE_LADDER
            self.n_idx_sizes = di.N_IDX_SIZES
        else:
            self.tile_ladder = di.TILE_LADDER_SMALL
            self.n_idx_sizes = di.N_IDX_SIZES_SMALL
        self.mesh = mesh
        self.lanes = lanes_per_shard * (mesh.devices.size if mesh is not None
                                        else 1)
        self.queries = query_reads
        by_bucket = {}
        for i, r in enumerate(query_reads):
            by_bucket.setdefault(_len_bucket(len(r[1])), []).append(i)
        self._by_bucket = by_bucket
        self._groups = None
        self.events = [[] for _ in query_reads]   # flat tagged endpoints
        # persistent host ReadStates for permanently host-processed
        # rows; populated lazily per group (first host access) so the
        # constructor performs no device->host pull
        self.host_state = {}
        self._host_state_done = set()
        self.n_host_fallback = 0
        self.n_host_only_parts = 0
        self.n_sharded_parts = 0
        self.n_device_calls = 0
        self.n_retry_steps = 0
        self.phase_s = defaultdict(float)   # wall time per phase
        self.flag_counts = defaultdict(int)

    @property
    def groups(self):
        """Query groups, staged lazily on first access so run() can
        overlap the staging (device sketch/compact per group) with the
        first part's host-side pack in the build thread."""
        if self._groups is None:
            gs = []
            for blen, idxs in sorted(self._by_bucket.items()):
                for off in range(0, len(idxs), self.lanes):
                    gs.append(_Group(idxs[off:off + self.lanes],
                                     self.queries, self.k, self.w,
                                     lanes=self.lanes, hpc=self.hpc))
            self._groups = gs
        return self._groups

    def _static(self, g, A, jring=J):
        return _make_static(self.cfg, self.lanes, g.M, g.M2, A, self.k,
                            self.chain, jring=jring)

    def run(self, target_iter, progress=None, parts=None):
        """Pipelined part loop (the kt_pipeline role, kthread.c:129-158):
        a one-slot prefetch thread reads/packs/sketches part N+1 and
        dispatches its index build while part N's query groups execute;
        JAX dispatch is thread-safe and device programs serialize on
        the device, so the overlap hides the host-side read/pack/python
        time."""
        import concurrent.futures as cf

        cfg = self.cfg
        part_iter = (iter(parts) if parts is not None
                     else oh.iter_index_parts(target_iter,
                                              cfg.index.batch_size))

        def build(part):
            t0 = time.time()
            pidx = _PartIndex(part, self.k, self.w, cfg.map.mid_occ,
                              cfg.map.mid_occ_frac,
                              self.tile_ladder, self.n_idx_sizes,
                              hpc=self.hpc)
            self.phase_s["index"] += time.time() - t0
            return pidx

        with cf.ThreadPoolExecutor(max_workers=1) as ex:
            nxt = next(part_iter, None)
            fut = ex.submit(build, nxt) if nxt is not None else None
            # stage query groups while the first part packs/builds on
            # the side thread (device work serializes on chip; the
            # overlap hides the host-side pack + python time)
            _ = self.groups
            while fut is not None:
                pidx = fut.result()
                nxt = next(part_iter, None)
                fut = ex.submit(build, nxt) if nxt is not None else None
                self._run_part(pidx, progress)
        t0 = time.time()
        rows = self._finalize()
        self.phase_s["finalize"] += time.time() - t0
        return rows

    def _step_group(self, g, pidx, qrank_d, qbisect_d, qvalid, A,
                    left, occ, jring=J):
        """Dispatch one (part x group) step; left/occ are the count
        pass's seed-lookup tables. Returns (packed_small, events_full)
        device arrays."""
        st = self._static(g, A, jring=jring)
        if self.hpc:
            return self._step_group_hpc(g, pidx, qrank_d, qbisect_d,
                                        qvalid, st, left, occ)
        if self.mesh is not None:
            # pin every input's sharding to its in_spec: without this,
            # arrays arriving with drifting (unspecified vs committed)
            # shardings re-key the jit cache and recompile the whole
            # shard_map program per engine instance (~40 s per point
            # in the virtual-mesh scaling harness)
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P
            step_fn = _sharded_step(self.mesh, st)
            rep = NamedSharding(self.mesh, P())
            l1 = NamedSharding(self.mesh, P("data"))
            l2 = NamedSharding(self.mesh, P("data", None))
            pt = jax.device_put
            args = (pt(pidx.irid, rep), pt(pidx.ips, rep),
                    pt(pidx.seq_lens, rep), pt(pidx.rid_rank, rep),
                    pt(pidx.mid_occ, rep),
                    pt(left, l2), pt(occ, l2), pt(g.qps, l2),
                    pt(g.qcnt, l2), pt(g.n_slots, l1), pt(g.n_exp, l1),
                    pt(g.qlen, l1), pt(qrank_d, l1), pt(qbisect_d, l1),
                    pt(qvalid, l1), pt(g.lam, l1), pt(g.lam2, l1),
                    pt(g.avgk_set, l1), pt(g.m_cnts, l2),
                    pt(self.limbs5, rep))
            (g.lam, g.lam2, g.avgk_set, g.m_cnts,
             small, full) = step_fn(*args)
            self.n_device_calls += 1
            return small, full
        step_fn = functools.partial(_step, st=st)
        (g.lam, g.lam2, g.avgk_set, g.m_cnts, small, full) = step_fn(
            pidx.irid, pidx.ips, pidx.seq_lens,
            pidx.rid_rank, pidx.mid_occ,
            left, occ, g.qps, g.qcnt, g.n_slots, g.n_exp,
            g.qlen, qrank_d, qbisect_d, qvalid,
            g.lam, g.lam2, g.avgk_set, g.m_cnts, self.limbs5)
        self.n_device_calls += 1
        return small, full

    def _step_group_hpc(self, g, pidx, qrank_d, qbisect_d, qvalid, st,
                        left, occ):
        """Two-phase HPC step: anchors + span stats on device, per-row
        gap-multiplier fit on host (avg_qspan is data-dependent under
        HPC), then DP + accounting on device."""
        (key1, key2, yq, js_s, span_s, n_anch, n_q, n_kept,
         stats) = _step_hpc_a(
            pidx.irid, pidx.ips, pidx.rid_rank, pidx.mid_occ,
            left, occ, g.qps, g.qcnt, g.n_slots, g.qspan, g.qlen,
            qrank_d, qbisect_d, st=st)
        stats_np = np.asarray(stats)
        Q = stats_np.shape[0]
        limbs = np.zeros((5, Q), np.int32)
        rbad = np.zeros((1, Q), np.int32)
        kept_avg = np.zeros(Q, np.float32)
        for r in range(Q):
            n_a, ssum, nk, kss, _nq = (int(x) for x in stats_np[r])
            if nk > 0:
                kept_avg[r] = np.float32(kss / nk)
            if n_a > 0:
                avg_q = float(np.float32(ssum / n_a))
                lb = penalty_limbs(avg_q, self.cfg.map.bw)
                if lb is None:
                    rbad[0, r] = 1
                else:
                    limbs[:, r] = lb
        (g.lam, g.lam2, g.avgk_set, g.avgk_val, g.m_cnts,
         small, full) = _step_hpc_b(
            key1, key2, yq, js_s, span_s, n_anch, n_q, n_kept,
            pidx.seq_lens, g.qlen, qvalid, g.n_exp,
            g.lam, g.lam2, g.avgk_set, g.avgk_val, g.m_cnts,
            jnp.asarray(limbs), jnp.asarray(rbad),
            jnp.asarray(kept_avg), st=st)
        self.n_device_calls += 1
        return small, full

    def _unpack_pull(self, small_np, events_full):
        """Decode a step's packed_small pull ([flags | ev_n | compact
        events] per mesh shard) into (flags (lanes,), per-row event
        arrays). A shard whose event total overflowed EV_B falls back
        to one pull of the uncompacted events_full (rare: needs > EV_B
        interval endpoints in one 128-row group)."""
        S = self.mesh.devices.size if self.mesh is not None else 1
        Qs = self.lanes // S
        blk = 2 * Qs + EV_B
        flags = np.empty(self.lanes, np.int32)
        ev_rows = [None] * self.lanes
        full_np = None
        for s in range(S):
            b = small_np[s * blk:(s + 1) * blk]
            en = b[Qs:2 * Qs]
            flags[s * Qs:(s + 1) * Qs] = b[:Qs]
            if int(en.sum()) > EV_B:
                if full_np is None:
                    full_np = np.asarray(events_full)
                for r in range(Qs):
                    ev_rows[s * Qs + r] = \
                        full_np[s * Qs + r, :int(en[r])]
                continue
            ev = b[2 * Qs:]
            off = 0
            for r in range(Qs):
                n = int(en[r])
                ev_rows[s * Qs + r] = ev[off:off + n]
                off += n
        return flags, ev_rows

    def _commit_rows(self, g, want, flags_np, ev_rows, progress,
                     forced=()):
        """Record interval events for rows of `want` that came back
        clean; return the rows that still need work. `forced`: rows
        whose device update was masked off up front (count pass said
        they exceed the top anchor rung) — treated as flagged."""
        forced = set(forced)
        for r in want:
            if flags_np[r] or g.perm_host[r] or r in forced:
                continue
            qi = g.qids[r]
            ev = ev_rows[r]
            if ev is not None and len(ev):
                self.events[qi].extend(int(x) for x in ev)
            if progress:
                progress(qi)
        return [r for r in want
                if flags_np[r] or g.perm_host[r] or r in forced]

    def _run_part(self, pidx, progress):
        """All query groups against one part: dispatch every group's
        step at the base anchor rung, then pull asynchronously; rows
        that overflowed the rung (F_ANCH) retry at bigger rungs, and
        whatever remains flagged is recomputed exactly on the host."""
        if self.mesh is not None and not pidx.host_only and \
                pidx.n_shards == 1:
            # replicate the part index across the mesh ONCE (the
            # per-call device_put in _step_group is then a no-op)
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P
            rep = NamedSharding(self.mesh, P())
            pidx.irid = jax.device_put(pidx.irid, rep)
            pidx.ips = jax.device_put(pidx.ips, rep)
            pidx.seq_lens = jax.device_put(pidx.seq_lens, rep)
            pidx.rid_rank = jax.device_put(pidx.rid_rank, rep)
            pidx.mid_occ = jax.device_put(pidx.mid_occ, rep)
        if self.mesh is not None and not pidx.host_only and \
                pidx.n_shards > 1:
            # the lane-sharded shard_map path replicates a 1-D index;
            # hash-range-sharded parts ride the host path under a mesh
            # (mesh runs are the virtual-CPU scaling harness — real
            # multi-part scale runs are single-device)
            pidx.host_only = True
        if pidx.host_only:
            # no silent scale cliff: count and log the event (bench
            # publishes host_only_parts)
            self.n_host_only_parts += 1
            logger.warning("part exceeds the device-index ceiling; "
                           "computed by the exact host path")
            t0 = time.time()
            for g in self.groups:
                self._host_fix(g, pidx, list(range(len(g.qids))),
                               progress)
            self.phase_s["host_fix"] += time.time() - t0
            return

        if pidx.n_shards > 1:
            self.n_sharded_parts += 1
        # --- rung pre-sizing: one cheap count program per group, all
        # dispatched before any pull, so each group's step runs at the
        # smallest anchor rung that fits every live row (step wall time
        # is linear in A; see A_BUCKETS note)
        t0 = time.time()
        counts = []
        for g in self.groups:
            qrank = np.full(self.lanes, -1, np.int32)
            qbisect = np.zeros(self.lanes, np.int32)
            for r, qi in enumerate(g.qids):
                qname = self.queries[qi][0]
                qrank[r] = pidx.name_rank.get(qname, -1)
                if self.cfg.ava:
                    qbisect[r] = bisect_left(pidx.sorted_names, qname)
            if pidx.n_shards > 1:
                cnt, left, occ = _count_expanded_sharded(
                    pidx.ih, pidx.bnd_ck, g.qh, g.qcnt, g.n_slots,
                    pidx.mid_occ, kb=pidx.kb, mcrop=g.count_crop())
            else:
                cnt, left, occ = _count_expanded(
                    pidx.ih, g.qh, g.qcnt, g.n_slots, pidx.mid_occ,
                    mcrop=g.count_crop())
            counts.append([g, jnp.asarray(qrank), jnp.asarray(qbisect),
                           cnt, left, occ])
        for c in counts:
            _async_pull(c[3])
        self.phase_s["count"] += time.time() - t0

        t0 = time.time()
        pend = []
        for g, qrank_d, qbisect_d, cnt, left, occ in counts:
            nq = np.asarray(cnt)
            live = np.zeros(self.lanes, bool)
            live[:len(g.qids)] = True
            live &= ~g.perm_host
            nq_max = int(nq[live].max()) if live.any() else 0
            rung = next((a for a in self.a_ladder if a >= nq_max), None)
            forced = []
            if rung is None:
                rung = self.a_ladder[-1]
                forced = [r for r in range(len(g.qids))
                          if live[r] and nq[r] > rung]
            qvalid = g.qvalid
            if forced:
                qv = np.asarray(g.qvalid).copy()
                qv[forced] = 0
                qvalid = jnp.asarray(qv)
            small, full = self._step_group(
                g, pidx, qrank_d, qbisect_d, qvalid, rung, left, occ)
            pend.append([g, qrank_d, qbisect_d, small, full, forced,
                         rung, left, occ])
        for p in pend:   # overlap the transfers with remaining compute
            _async_pull(p[3])
        self.phase_s["step"] += time.time() - t0

        for (g, qrank_d, qbisect_d, small, full, forced, rung, left,
             occ) in pend:
            t0 = time.time()
            flags_np, ev_rows = self._unpack_pull(np.asarray(small),
                                                  full)
            self.phase_s["pull"] += time.time() - t0
            want = list(range(len(g.qids)))
            bad = self._commit_rows(g, want, flags_np, ev_rows,
                                    progress, forced=forced)
            for r in forced:
                self.flag_counts[F_ANCH] += 1
            # F_ANCH safety net: the count pass should have sized the
            # rung so this never fires; escalate past the used rung if
            # a count/step disagreement ever surfaces
            rung0 = self.a_ladder.index(rung) if rung in self.a_ladder \
                else 0
            for ri in range(rung0 + 1, len(self.a_ladder)):
                retry = [r for r in bad
                         if (flags_np[r] & F_ANCH) and not g.perm_host[r]]
                if not retry:
                    break
                t0 = time.time()
                qv = np.zeros(self.lanes, np.int32)
                qv[retry] = 1
                small2, full2 = self._step_group(
                    g, pidx, qrank_d, qbisect_d, jnp.asarray(qv),
                    self.a_ladder[ri], left, occ)
                self.n_retry_steps += 1
                flags2, ev_rows2 = self._unpack_pull(
                    np.asarray(small2), full2)
                for r in retry:
                    flags_np[r] = flags2[r]
                    ev_rows[r] = ev_rows2[r]
                self.phase_s["step"] += time.time() - t0
                bad2 = self._commit_rows(g, retry, flags_np, ev_rows,
                                         progress)
                bad = [r for r in bad if r not in retry] + bad2
            # F_KERNEL escalation: rows whose J=64 predecessor ring
            # truncated (repeat-dense anchor runs, long dense overlaps)
            # retry once at J_RETRY before the host fallback (chain.c:41-80
            # max_skip band semantics hold at any ring depth >= the
            # row's true predecessor reach; one retry rung means one
            # extra step program per anchor rung to compile)
            retry = [r for r in bad
                     if flags_np[r] == F_KERNEL and not g.perm_host[r]]
            if retry:
                t0 = time.time()
                qv = np.zeros(self.lanes, np.int32)
                qv[retry] = 1
                small2, full2 = self._step_group(
                    g, pidx, qrank_d, qbisect_d, jnp.asarray(qv),
                    rung, left, occ, jring=J_RETRY)
                self.n_retry_steps += 1
                flags2, ev_rows2 = self._unpack_pull(
                    np.asarray(small2), full2)
                for r in retry:
                    flags_np[r] = flags2[r]
                    ev_rows[r] = ev_rows2[r]
                self.phase_s["step"] += time.time() - t0
                bad2 = self._commit_rows(g, retry, flags_np, ev_rows,
                                         progress)
                bad = [r for r in bad if r not in retry] + bad2
            for r in bad:
                if flags_np[r]:
                    self.flag_counts[int(flags_np[r])] += 1
            if bad:
                t0 = time.time()
                self._host_fix(g, pidx, bad, progress)
                self.phase_s["host_fix"] += time.time() - t0

    def _ensure_host_state(self, g):
        """Create persistent host ReadStates for this group's
        permanently host-processed rows (lazy: first host access)."""
        if id(g) in self._host_state_done:
            return
        self._host_state_done.add(id(g))
        for r, qi in enumerate(g.qids):
            if g.perm_host[r]:
                sk = g.host_sketch_lists(self.k, self.w, self.queries)[r]
                self.host_state[qi] = oh.ReadState(len(sk[0]))

    def _host_fix(self, g, pidx, rows, progress):
        """Exact host recompute of this part's update for flagged rows
        (their device state was left untouched by _step)."""
        self._ensure_host_state(g)
        cfg = self.cfg
        m = cfg.map
        hidx = pidx.host_index()
        if m.mid_occ:
            mid_occ = m.mid_occ
        elif pidx.mid_occ is not None:
            mid_occ = int(pidx.mid_occ)
        else:
            # host_only part: no device index exists — the host spec's
            # own occurrence quantile (index.c:123-144)
            mid_occ = hidx.mid_occ(m.mid_occ_frac)
        fopt = {"seq_lens": hidx.seq_lens,
                "min_ratio": cfg.flt.min_ratio,
                "max_overhang": cfg.flt.max_overhang}
        sk = g.host_sketch_lists(self.k, self.w, self.queries)
        lam = np.asarray(g.lam).copy()
        lam2 = np.asarray(g.lam2).copy()
        avgk = np.asarray(g.avgk_set).copy()
        avgkv = np.asarray(g.avgk_val).copy() if g.hpc else None
        mcn = np.asarray(g.m_cnts).copy()
        n_exp_np = np.asarray(g.n_exp)
        mask = np.zeros(self.lanes, np.int32)
        for r in rows:
            qi = g.qids[r]
            self.n_host_fallback += 1
            q = self.queries[qi]
            if qi in self.host_state:
                state = self.host_state[qi]
            else:
                state = oh.ReadState(0)
                state.lam = int(lam[r])
                state.lam2 = int(lam2[r])
                if not avgk[r]:
                    state.avg_k = np.float32(0.0)
                elif g.hpc:
                    state.avg_k = np.float32(avgkv[r])
                else:
                    state.avg_k = np.float32(self.k)
                n_exp = int(n_exp_np[r])
                mc_row = np.zeros(max(n_exp, len(sk[r][0])), np.uint16)
                upto = min(n_exp, g.M2)
                mc_row[:upto] = mcn[r, :upto].astype(np.uint16)
                state.m_cnts = mc_row
            state.coords = []
            ax, ay, mini_pos = oh.collect_seed_hits(
                hidx, q[0], len(q[1]), sk[r], mid_occ,
                no_self=True, ava=cfg.ava)
            chains = oh.chain_dp(ax, ay, m.max_gap, m.bw,
                                 m.max_chain_skip, m.min_cnt,
                                 m.min_chain_score)
            regs = [oh.chain_to_reg(ax, ay, len(q[1]), sc, idx)
                    for sc, idx in chains]
            cv = oh.lq_cnt_match(state, len(q[1]), regs, ax, ay,
                                 mini_pos, m.min_score_med,
                                 m.min_score_good, fopt, covt=cfg.covt)
            oh.filter_redundant_coords(state, cv, cfg.flt.min_coverage)
            for s, e in state.coords:
                self.events[qi].append(int(np.uint32(s)))
                self.events[qi].append(int(np.uint32(e)))
            if progress:
                progress(qi)
            if qi in self.host_state:
                continue  # state lives host-side permanently
            lam[r] = state.lam
            lam2[r] = state.lam2
            avgk[r] = 1 if state.avg_k != 0.0 else 0
            if g.hpc:
                avgkv[r] = state.avg_k
            mcn[r, :] = 0
            upto = min(len(state.m_cnts), g.M2)
            mcn[r, :upto] = state.m_cnts[:upto].astype(np.int32)
            mask[r] = 1
        if mask.any():
            (g.lam, g.lam2, g.avgk_set, g.m_cnts) = _apply_fix(
                g.lam, g.lam2, g.avgk_set, g.m_cnts, jnp.asarray(mask),
                jnp.asarray(lam), jnp.asarray(lam2), jnp.asarray(avgk),
                jnp.asarray(mcn))
            if g.hpc:
                g.avgk_val = jnp.asarray(avgkv)

    def _finalize(self):
        cfg = self.cfg
        rows = [None] * len(self.queries)
        # dispatch every group's reduction before the first pull so the
        # transfers overlap (and only the first pull eats any latency)
        outs = []
        for g in self.groups:
            out = _finalize_group(g.lam, g.lam2, g.m_cnts, g.n_exp)
            for a in out[:3]:
                _async_pull(a)
            outs.append(out)
        for g, (lam, lam2, n_match, _ssum) in zip(self.groups, outs):
            self._ensure_host_state(g)
            lam = np.asarray(lam)
            lam2 = np.asarray(lam2)
            n_match = np.asarray(n_match)
            n_exp = np.asarray(g.n_exp)
            avgkv = np.asarray(g.avgk_val) if g.hpc else None
            for r, qi in enumerate(g.qids):
                q = self.queries[qi]
                if qi in self.host_state:
                    st = self.host_state[qi]
                    mv_n = len(st.m_cnts)
                    if mv_n > 0:
                        ssum = int(st.m_cnts.astype(np.uint64).sum()
                                   % (1 << 32)) // mv_n
                        nm = int((st.m_cnts > ssum).sum())
                    else:
                        nm = 0
                    div = oh.div_score(mv_n, nm, st.avg_k)
                    lam_r, lam2_r = st.lam, st.lam2
                else:
                    avg_k = (np.float32(avgkv[r]) if g.hpc
                             else np.float32(self.k))
                    div = oh.div_score(int(n_exp[r]), int(n_match[r]),
                                       avg_k)
                    lam_r, lam2_r = int(lam[r]), int(lam2[r])
                vc = sorted(self.events[qi])
                rows[qi] = oh.emit_row(
                    q[0], len(q[1]), q[2], lam_r, lam2_r,
                    div, vc, cfg.flt.min_coverage, cfg.filter_mode)
        return rows


def overlap_run_device2(target_iter, query_reads, cfg: OverlapConfig,
                        progress=None, mesh=None,
                        lanes_per_shard=GROUP_Q, parts=None):
    """Device-resident overlap run -> 9-column TSV rows (row-identical
    to overlap_host.overlap_run). With mesh, query lanes shard over the
    mesh's "data" axis (index replicated)."""
    eng = DeviceOverlapEngine(cfg, query_reads, mesh=mesh,
                              lanes_per_shard=lanes_per_shard)
    rows = eng.run(target_iter, progress=progress, parts=parts)
    logger.info("device overlap: %d rows, %d device calls, %d host-fixed "
                "rows, %d host-only parts, flags %s, phase seconds %s",
                len(rows), eng.n_device_calls, eng.n_host_fallback,
                eng.n_host_only_parts, dict(eng.flag_counts),
                {k: round(v, 3) for k, v in sorted(eng.phase_s.items())})
    return rows
