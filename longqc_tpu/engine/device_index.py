"""Canonical-shape device index build for the overlap engine.

The index pipeline is built from fixed-shape pieces that compile once
per *configuration*, never per dataset (shapes that tracked the part
size would recompile for every new input):

  reads --host pack--> multi-read 2-bit tiles (R, W fixed; reads laid
      back-to-back in a row behind w-1 ambiguous separator bases)
    --fused device program per tile--> unpack -> segment-gated sketch
      (ops/sketch._sketch_core seg mode) -> per-row compaction with
      read-id/local-position mapping -> duplicate-emission expansion
      -> single-key sort by hash  => one sorted chunk of TILE_SLOTS
    --merge tree--> pairwise merge-path combines (fixed sizes
      TILE_SLOTS * 2^j) => one sorted (hash, rid, pos<<1|strand) array
    --canonical pad--> N_idx in {2^16, 2^20, 2^24} INF-padded index
    --device mid_occ--> kth-occurrence threshold by binary search on
      the value (no sort of counts), cf. mm_idx_cal_max_occ
      (index.c:123-144)

Single-key sorting (hash only) is exact: within a hash run all entries
share the same k-mer, and anchors that tie on the chain sort keys
(rev<<24|rid, rpos) are bit-identical duplicates whose relative order
cannot change any emitted row (see engine/device_overlap docstring;
enforced by the row-identity differential tests).

Behavioral citations: sketch.c:76-142 (minimizers), index.c:69-144
(index + occurrence threshold), bseq.c:68 (batching by base budget).
"""

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from longqc_tpu.io.pack import SEQ_NT4_SKETCH
from longqc_tpu.ops.chain_ring import INF32
from longqc_tpu.ops.sketch import _sketch_core

# single-pass encode tables: ASCII byte -> 2-bit code / ambiguity
_CODE_OF = np.where(SEQ_NT4_SKETCH < 4, SEQ_NT4_SKETCH, 0).astype(np.uint8)
_AMB_OF = SEQ_NT4_SKETCH >= 4

# tile ladder: all levels hold the same number of bases / flat slots so
# every level feeds the same sort/merge machinery
TILE_LADDER = ((256, 8192), (32, 65536), (4, 524288))
JUMBO_W = 1 << 22          # single-row tiles for ultra-long reads
READS_PER_ROW = 64
# canonical index widths on the production geometry: every part pads to
# the smallest fitting width, so at most one step program exists per
# (M, A, N). Rungs: 2M real entries covers parts to ~6 Mbp of target
# sequence (the 5000-read sample class; chunk cropping makes the width
# track real entries, not slots); 8M to ~24 Mbp. Bigger parts build the
# hash-range-sharded stack of 8M-wide shards (D5 in ROADMAP asks
# whether one wider index would do on the GPU).
N_IDX_SIZES = (1 << 21, 1 << 22, 1 << 23)

# small-geometry ladder for tests / tiny workloads (same code paths,
# cheap compiles on the CPU backend). The ladder is dense: a width
# jump straight from 2^15 to 2^24 made every ~40K-entry CPU test pay
# 16M-wide counts/sorts of padding
N_IDX_SIZES_SMALL = (1 << 12, 1 << 15, 1 << 17, 1 << 19, 1 << 21,
                     1 << 24)
TILE_LADDER_SMALL = ((16, 2048), (4, 8192), (1, 32768))


@dataclass
class Tile:
    """One packed multi-read tile (host arrays, ready for device put)."""
    R: int
    W: int
    codes2: np.ndarray      # (R, W//16) uint32, 2-bit codes
    nmask: np.ndarray       # (R, W//32) uint32, 1 = ambiguous/padding
    startmask: np.ndarray   # (R, W//32) uint32, 1 = segment start
    endmask: np.ndarray     # (R, W//32) uint32, 1 = read's last column
    starts: np.ndarray      # (R, READS_PER_ROW) int32 read start pos
    gids: np.ndarray        # (R, READS_PER_ROW) int32 global read id
    used: np.ndarray        # (R,) int32 row used width
    n_reads: int


class _TileBuilder:
    def __init__(self, R, W, sep):
        self.R, self.W, self.sep = R, W, sep
        self.rows = []          # list of list[(gid, seq)]
        self.cur = []
        self.cur_used = 0

    def add(self, gid, seq):
        need = len(seq) + (self.sep if self.cur else 0)
        if self.cur and (self.cur_used + need > self.W
                         or len(self.cur) >= READS_PER_ROW):
            self.rows.append(self.cur)
            self.cur = []
            self.cur_used = 0
            need = len(seq)
        self.cur.append((gid, seq))
        self.cur_used += need

    def flush(self):
        if self.cur:
            self.rows.append(self.cur)
            self.cur = []
            self.cur_used = 0

    def tiles(self):
        self.flush()
        out = []
        for off in range(0, len(self.rows), self.R):
            out.append(self._pack(self.rows[off:off + self.R]))
        return out

    def _pack(self, rows):
        """Pack one tile. The python loop only computes the LAYOUT
        (per-read row/column offsets — list appends); base encoding
        and mask fills run as single vectorized passes over the whole
        tile instead of a per-read slice-assignment loop."""
        R, W, sep = self.R, self.W, self.sep
        starts = np.zeros((R, READS_PER_ROW), np.int32)
        gids = np.full((R, READS_PER_ROW), -1, np.int32)
        used = np.zeros(R, np.int32)
        seqs, rposs, rlens = [], [], []
        start_cols, end_cols = [], []     # flat R*W scatter targets
        n_reads = 0
        for r, row in enumerate(rows):
            pos = 0
            for j, (gid, seq) in enumerate(row):
                if j > 0:
                    # separators belong to the NEXT segment: a window
                    # ending at a separator entry may only ever track
                    # entries of the read the separators precede
                    start_cols.append(r * W + pos)
                    pos += sep
                else:
                    start_cols.append(r * W)
                seqs.append(seq)
                rposs.append(r * W + pos)
                rlens.append(len(seq))
                starts[r, j] = pos
                gids[r, j] = gid
                pos += len(seq)
                end_cols.append(r * W + pos - 1)
                n_reads += 1
            used[r] = pos
        raw = np.frombuffer("".join(seqs).encode("ascii"), np.uint8)
        rlens = np.asarray(rlens, np.int32)
        cum = np.concatenate([np.zeros(1, np.int64),
                              np.cumsum(rlens)]).astype(np.int64)
        # ragged arange: flat tile index of every base of every read
        tgt = np.arange(cum[-1], dtype=np.int64)
        tgt += np.repeat(np.asarray(rposs, np.int64) - cum[:-1], rlens)
        codes = np.zeros(R * W, np.uint8)
        amb = np.ones(R * W, bool)          # padding counts as ambiguous
        codes[tgt] = _CODE_OF[raw]
        amb[tgt] = _AMB_OF[raw]
        startb = np.zeros(R * W, bool)
        startb[np.asarray(start_cols, np.int64)] = True
        endb = np.zeros(R * W, bool)
        endb[np.asarray(end_cols, np.int64)] = True
        return Tile(R, W, _packbits32(codes.reshape(R, W)),
                    _packbits32(amb.reshape(R, W)),
                    _packbits32(startb.reshape(R, W)),
                    _packbits32(endb.reshape(R, W)),
                    starts, gids, used, n_reads)


def _to_bits2(codes):
    """(R, W) u8 codes 0..3 -> (R, W) already fine; kept for clarity."""
    return codes


def _packbits32(arr):
    """Bit/2-bit packing into uint32 words, little-endian in the word.

    Boolean arrays pack 32/word; uint8 code arrays (values 0..3) pack
    16/word.
    """
    if arr.dtype == np.uint8:
        R, W = arr.shape
        a = arr.reshape(R, W // 16, 16).astype(np.uint32)
        shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
        return (a << shifts).sum(axis=2, dtype=np.uint32)
    R, W = arr.shape
    a = arr.reshape(R, W // 32, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[None, None, :]
    return (a << shifts).sum(axis=2, dtype=np.uint32)


def pack_part_tiles(part, w, ladder=TILE_LADDER, jumbo_w=JUMBO_W):
    """Pack a part's reads into multi-read tiles (+ jumbo single-read
    tiles for reads longer than the ladder top). Returns
    (tiles, jumbo_tiles)."""
    sep = max(w - 1, 1)
    builders = [_TileBuilder(R, W, sep) for R, W in ladder]
    tops = [W for _R, W in ladder]
    jumbo = []
    for gid, r in enumerate(part):
        seq = r[1]
        for lvl, top in enumerate(tops):
            if len(seq) <= top:
                builders[lvl].add(gid, seq)
                break
        else:
            jw = jumbo_w
            while jw < len(seq):
                jw *= 2
            b = _TileBuilder(1, jw, sep)
            b.add(gid, seq)
            jumbo.extend(b.tiles())
    tiles = []
    for b in builders:
        tiles.extend(b.tiles())
    return tiles, jumbo


# ---------------------------------------------------------------------------
# device programs


def _unpack2(words, W):
    """(R, W//16) u32 -> (R, W) int32 2-bit fields."""
    R = words.shape[0]
    w32 = words.astype(jnp.uint32)[:, :, None]
    shifts = jnp.arange(16, dtype=jnp.uint32)[None, None, :] * 2
    return ((w32 >> shifts) & 3).astype(jnp.int32).reshape(R, W)


def _unpack1(words, W):
    """(R, W//32) u32 -> (R, W) bool."""
    R = words.shape[0]
    w32 = words.astype(jnp.uint32)[:, :, None]
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    return (((w32 >> shifts) & 1) != 0).reshape(R, W)


def infk(dtype):
    """Hash sentinel: the dtype's max (INF32 for the i32 fast path,
    int64 max for the wide-hash path; both sort after every real
    hash)."""
    return np.array(np.iinfo(np.dtype(dtype)).max, dtype)


@functools.partial(jax.jit,
                   static_argnames=("R", "W", "k", "w", "full_width",
                                    "wide"))
def tile_flat(codes2, nmask, startmask, endmask, starts, gids, used, *,
              R, W, k, w, full_width=False, wide=False):
    """Fused per-tile program: unpack -> segment sketch -> flatten with
    read-id mapping -> duplicate expansion -> single-key sort.

    Returns (ih, irid, ips) sorted by hash with sentinel hashes on
    empty slots (R*M each), n_exp_total, row_overflow (R,) bool
    (a row's emissions exceeded its M slots), exp_overflow scalar.

    M = W//2 normally (minimizer density is ~2/(w+1) < 1/2 except on
    adversarial periodic rows); full_width (M = W) is the stage-2
    fallback for rows that overflowed — emissions per row can never
    exceed W, so stage-2 row overflow is impossible.

    wide: hashes ride int64 lanes (2k > 30, e.g. the pb-hifi fast
    preset's k = 19; bare u64 sketch hashes < 2^2k cast losslessly).
    """
    M = W if full_width else W // 2
    hdt = jnp.int64 if wide else jnp.int32
    INFH = infk(np.int64 if wide else np.int32)
    codes = _unpack2(codes2, W)
    amb = _unpack1(nmask, W)
    startb = _unpack1(startmask, W)
    codes = jnp.where(amb, 4, codes).astype(jnp.uint8)
    seg = jnp.cumsum(startb.astype(jnp.int32), axis=1) - 1

    res = _sketch_core(codes, used, w=w, k=k, seg=seg)
    emit, hsh, pos, strand = (res["emit"], res["hash"], res["pos"],
                              res["strand"])
    seg_s = res["seg"]

    # per-row compaction of emitting entries into M slots
    has = emit > 0
    posl = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :],
                            (R, W))
    order = jnp.argsort(jnp.where(has, posl, INF32), axis=1)[:, :M]
    n = jnp.sum(has, axis=1).astype(jnp.int32)
    slot_on = jnp.arange(M, dtype=jnp.int32)[None, :] < \
        jnp.minimum(n, M)[:, None]

    def take(a):
        return jnp.take_along_axis(a, order, axis=1)

    seg_e = jnp.clip(take(seg_s), 0, READS_PER_ROW - 1)
    rid = jnp.take_along_axis(gids, seg_e, axis=1)
    rstart = jnp.take_along_axis(starts, seg_e, axis=1)
    local = take(pos.astype(jnp.int32)) - rstart
    if wide:
        h_take = take(hsh).astype(jnp.int64)
    else:
        h_take = take(hsh.astype(jnp.uint32).astype(jnp.int32))
    h = jnp.where(slot_on & (rid >= 0), h_take, INFH)
    rids = jnp.where(slot_on, jnp.maximum(rid, 0), 0)
    ps = jnp.where(slot_on, (local << 1) | take(strand.astype(jnp.int32)),
                   0)
    cnt = jnp.where(h != INFH, take(emit.astype(jnp.int32)), 0)

    # row-wise duplicate expansion (emissions with cnt > 1); a row
    # whose EXPANDED count exceeds its M slots joins the overflow redo
    # (full_width M = W always fits: emissions are one per window)
    eh, er, ep, n_exp_total, n_exp_r = _expand_rows(h, rids, ps, cnt,
                                                    INFH)
    row_overflow = (n > M) | (n_exp_r > M)
    exp_overflow = jnp.array(False)

    ih, irid, ips = jax.lax.sort((eh, er, ep), dimension=0, num_keys=1,
                                 is_stable=False)
    return ih, irid, ips, n_exp_total, row_overflow, exp_overflow


@functools.partial(jax.jit, static_argnames=("n",))
def merge_sorted(ka, pa1, pa2, kb, pb1, pb2, *, n):
    """Merge two sorted n-long (key, payload, payload) triples into a
    2n-long sorted triple via the merge-path diagonal search (ties take
    from the left/A side first). Pure gathers — no sort."""
    j = jnp.arange(2 * n, dtype=jnp.int32)
    lo = jnp.maximum(j - n, 0)
    hi = jnp.minimum(j, n)
    # binary search for a = #taken from A at output position j:
    # invariant: A[a-1] <= B[j-a] for a <= a_j, A[a] < ... standard
    for _ in range(int(np.log2(n)) + 1):
        mid = (lo + hi + 1) >> 1
        a_val = ka[jnp.clip(mid - 1, 0, n - 1)]
        b_val = kb[jnp.clip(j - mid, 0, n - 1)]
        b_in = (j - mid) < n
        take_more = (mid <= j) & (mid <= n) & (mid >= 1) & \
            (~b_in | (a_val <= b_val))
        lo = jnp.where(take_more, jnp.maximum(lo, mid), lo)
        hi = jnp.where(take_more, hi, jnp.minimum(hi, mid - 1))
    a = lo
    b = j - a
    a_c = jnp.clip(a, 0, n - 1)
    b_c = jnp.clip(b, 0, n - 1)
    a_ok = a < n
    b_ok = b < n
    from_a = a_ok & (~b_ok | (ka[a_c] <= kb[b_c]))
    k_o = jnp.where(from_a, ka[a_c], kb[b_c])
    p1 = jnp.where(from_a, pa1[a_c], pb1[b_c])
    p2 = jnp.where(from_a, pa2[a_c], pb2[b_c])
    return k_o, p1, p2


@functools.partial(jax.jit, static_argnames=("n_out",))
def pad_to(ka, pa1, pa2, *, n_out):
    n = ka.shape[0]
    fill = jnp.full((n_out - n,), infk(ka.dtype), ka.dtype)
    zero = jnp.zeros((n_out - n,), jnp.int32)
    return (jnp.concatenate([ka, fill]),
            jnp.concatenate([pa1, zero]),
            jnp.concatenate([pa2, zero]))


@jax.jit
def sort_index(eh, er, ep):
    """Single-key sort of the concatenated (hash, rid, pos) chunks at
    the canonical index width (one XLA sort replaces a merge-path
    gather tree)."""
    return jax.lax.sort((eh, er, ep), dimension=0, num_keys=1,
                        is_stable=False)


def _expand_rows(h2, r2, p2, c2, INFH):
    """Row-wise duplicate expansion: entry j of row r (multiplicity
    c2[r, j]) occupies output slots [wstart, wstart + c2) of the SAME
    row, wstart = exclusive row cumsum. Inter-row gaps stay as INFH
    holes — the caller's single-key sort compacts them to the tail for
    free, so no global (1-D full-width) compaction pass exists at all.
    Every op here is a row op; no 1-D full-width scatter or gather.

    Returns flattened (eh, er, ep), n_exp_total (sum of per-row
    expanded counts, uncapped), and n_exp_r (R,) for overflow flags.
    """
    R, C = h2.shape
    ccum = jnp.cumsum(c2, axis=1)
    n_exp_r = ccum[:, -1].astype(jnp.int32)
    wstart = (ccum - c2).astype(jnp.int32)
    rows = jax.lax.broadcasted_iota(jnp.int32, (R, C), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (R, C), 1)
    # scatter each entry's VALUES at its expanded start column, then
    # forward-fill with one tuple-operand "last valid wins" scan —
    # value propagation instead of a source-index scan + three row
    # gathers (the tuple scan is one fused pass)
    tgt = jnp.where(c2 > 0, wstart, C)

    def place(a, fill):
        out = jnp.full((R, C), fill, a.dtype)
        return out.at[rows, tgt].set(a, mode="drop")

    sh = place(h2, INFH)         # INFH doubles as the "empty" mark
    sr_ = place(r2, 0)
    sp = place(p2, 0)

    def op(a, b):
        ah, ar, ap = a
        bh, br, bp = b
        keep_b = bh != INFH
        return (jnp.where(keep_b, bh, ah),
                jnp.where(keep_b, br, ar), jnp.where(keep_b, bp, ap))

    fh, fr, fp = jax.lax.associative_scan(op, (sh, sr_, sp), axis=1)
    on = cols < n_exp_r[:, None]
    eh = jnp.where(on, fh, INFH).reshape(-1)
    er = jnp.where(on, fr, 0).reshape(-1)
    ep = jnp.where(on, fp, 0).reshape(-1)
    n_exp_total = jnp.sum(n_exp_r.astype(jnp.int64)).astype(jnp.int32)
    return eh, er, ep, n_exp_total, n_exp_r


@functools.partial(jax.jit, static_argnames=("frac",))
def kth_of(n_keys, *, frac):
    """kth index for the occurrence quantile, computed on device
    bit-exactly like the host spec: float64 product (round-to-nearest)
    then truncation, clamped to n-1 (int((1.0 - frac) * n))."""
    n64 = n_keys.astype(jnp.float64)
    kth = jnp.trunc((1.0 - frac) * n64).astype(jnp.int32)
    return jnp.minimum(kth, n_keys - 1)


class IndexOverflowError(RuntimeError):
    """Even the full-width stage-2 tile overflowed duplicate expansion
    (requires > W emissions in one row — extreme adversarial input) or
    hash-range sharding could not balance within max_shards. Callers
    fall back to the exact host index for the part."""


# --------------------------------------------------------------------------
# hash-range-sharded index (parts past one canonical width; the
# reference contract is -I 4G parts, minimap2-coverage.c:266-269)
#
# _shard_ck_note: shard s owns hashes in [s << (kb - lg S),
# (s+1) << (kb - lg S)), kb = 2k — the invertible minimizer hash is
# uniform, so ranges balance. Each shard is its own INFH-padded
# canonical-width sorted array; the stack (S, N_top) is searched as a
# single virtual array under the key
#     ck(pos) = ((pos >> lg N_top) << kb) + min(h[pos], 2^kb)
# which is globally monotone (pads map to exactly 2^kb, sorting at the
# next shard's base) and collision-free against query keys
# ck(q) = (shard(q) << kb) + q < 2^kb increment — so
# occ = left(ck+1) - left(ck) counts exactly the real slots of hash q.
# Every key's slot run stays contiguous inside one shard, so anchor
# gathers and mid_occ keep their single-index semantics.

MAX_SHARDS = 32
_N_BND = 8192          # virtual-key boundary count for the 2-level search
_RL_LADDER = 8192      # exact mid_occ ladder (values past it ride a
                       # tiny tail pull: #keys with count >= 8192 is
                       # <= N_top/8192 per shard)


@functools.partial(jax.jit, static_argnames=("W_seg",))
def _slice_mask(ih, irid, ips, start, delta, ln, *, W_seg):
    """Fixed-width window [start, start+W_seg) of a sorted run; slots
    outside [delta, delta+ln) of the window are INFH-masked (start is
    pre-clamped on host so the window stays in bounds)."""
    sl_h = jax.lax.dynamic_slice(ih, (start,), (W_seg,))
    sl_r = jax.lax.dynamic_slice(irid, (start,), (W_seg,))
    sl_p = jax.lax.dynamic_slice(ips, (start,), (W_seg,))
    j = jnp.arange(W_seg, dtype=jnp.int32)
    on = (j >= delta) & (j < delta + ln)
    return (jnp.where(on, sl_h, infk(ih.dtype)),
            jnp.where(on, sl_r, 0), jnp.where(on, sl_p, 0))


@jax.jit
def _bounds_offsets(ih, bnd_vals):
    """searchsorted-left of the shard boundary values in one sorted
    run (a handful of queries — pulled once per part)."""
    return jnp.searchsorted(ih, bnd_vals, side="left").astype(jnp.int64)


@jax.jit
def _rl_ladder(rl):
    """#keys with occurrence count <= v for v in 1.._RL_LADDER, from a
    shard's ascending run-length array."""
    v = jnp.arange(1, _RL_LADDER + 1, dtype=rl.dtype)
    return jnp.searchsorted(rl, v, side="right").astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("S", "kb", "n_bnd"))
def _bnd_ck(ih_stack, *, S, kb, n_bnd=_N_BND):
    """Virtual-key boundaries: ck at every (S*N_top/n_bnd)-th flat
    position of the shard stack (phase 1 of the sharded seed search
    compare-sums against these)."""
    Ns = ih_stack.shape[1]
    stride = (S * Ns) // n_bnd
    pos = jnp.arange(n_bnd, dtype=jnp.int32) * stride
    srow = pos // Ns
    col = pos % Ns
    v = ih_stack[srow, col].astype(jnp.int64)
    vc = jnp.minimum(v, jnp.int64(1) << kb)
    return (srow.astype(jnp.int64) << kb) + vc


def _mid_occ_sharded(ih_stack, mid_occ_fixed, mid_occ_frac):
    """Exact global occurrence quantile across hash-range shards (each
    key lives wholly in one shard, so the global count multiset is the
    union of per-shard multisets). Per-shard runlen_sorted (canonical
    sorts) + one small ladder pull; counts past the ladder merge from
    tiny tail slices (provably <= N_top/_RL_LADDER keys per shard)."""
    if mid_occ_fixed:
        return jnp.asarray(np.int32(mid_occ_fixed))
    S = ih_stack.shape[0]
    lads, rls, nks = [], [], []
    for s in range(S):
        rl, nk = runlen_sorted(ih_stack[s])
        rls.append(rl)
        nks.append(nk)
        lads.append(_rl_ladder(rl))
    lad_np = [np.asarray(a) for a in lads]
    nk_np = [int(np.asarray(x)) for x in nks]
    n = sum(nk_np)
    if n == 0:
        return jnp.asarray(np.int32(1))
    kth = min(int((1.0 - mid_occ_frac) * n), n - 1)
    cnt = np.sum(lad_np, axis=0)          # cnt[v-1] = #keys with <= v
    hit = np.nonzero(cnt >= kth + 1)[0]
    if len(hit):
        return jnp.asarray(np.int32(int(hit[0]) + 1 + 1))
    # quantile sits past the ladder: merge the per-shard tails exactly
    import jax as _jax
    tail_w = min(4096, int(ih_stack.shape[1]))
    tails = []
    for s in range(S):
        start = max(nk_np[s] - tail_w, 0)
        t = np.asarray(_jax.lax.dynamic_slice(
            rls[s], (np.int32(start),), (tail_w,)))
        t = t[t > _RL_LADDER - 1]
        t = t[t < np.iinfo(np.int32).max]
        tails.append(t)
    tail = np.sort(np.concatenate(tails))
    # kth within the tail region: ranks below the tail are cnt[-1]
    r = kth - int(cnt[-1])
    r = min(max(r, 0), len(tail) - 1)
    return jnp.asarray(np.int32(int(tail[r]) + 1))


def build_sharded_from_chunks(chunks, k, *, n_top, mid_occ_fixed,
                              mid_occ_frac, max_shards=MAX_SHARDS):
    """Assemble the hash-range-sharded index from per-tile sorted
    chunks. Chunks group into G sorted runs of <= n_top slots (the
    existing canonical merge); each run's shard segments are contiguous
    (runs are sorted), their offsets come from one tiny boundary pull,
    and every shard assembles as G fixed-width masked windows + the
    cached canonical n_top sort. S doubles until every (run, shard)
    segment fits its window (hash uniformity makes skew tiny; a part
    that cannot balance within max_shards — a pathological repeat
    spectrum — raises IndexOverflowError for the host fallback)."""
    kb = 2 * k
    runs = []
    cur, cur_n = [], 0
    for c in chunks:
        n = int(c[0].shape[0])
        if cur and cur_n + n > n_top:
            runs.append(_merge_chunks(cur, (n_top,))[0])
            cur, cur_n = [], 0
        cur.append(c)
        cur_n += n
    if cur:
        runs.append(_merge_chunks(cur, (n_top,))[0])
    G = len(runs)
    W_seg = (n_top // G) // 1024 * 1024
    if W_seg == 0:
        raise IndexOverflowError("part too large for shard windows")
    dt = runs[0][0].dtype
    S = 2
    while True:
        lgS = S.bit_length() - 1
        bnd_vals = jnp.asarray(np.array(
            [min(s << (kb - lgS), np.iinfo(np.dtype(dt)).max)
             for s in range(S + 1)], dtype=dt))
        offs = np.stack([np.asarray(_bounds_offsets(r[0], bnd_vals))
                         for r in runs])
        seg = offs[:, 1:] - offs[:, :-1]
        if seg.max() <= W_seg:
            break
        S *= 2
        if S > max_shards:
            raise IndexOverflowError(
                "hash-range sharding could not balance (pathological "
                "repeat spectrum)")
    N = runs[0][0].shape[0]
    shard_arrs = []
    for s in range(S):
        pieces = [[], [], []]
        for g, r in enumerate(runs):
            off = int(offs[g, s])
            ln = int(seg[g, s])
            start = min(off, N - W_seg)
            delta = off - start
            p = _slice_mask(r[0], r[1], r[2], np.int32(start),
                            np.int32(delta), np.int32(ln), W_seg=W_seg)
            for i in range(3):
                pieces[i].append(p[i])
        pad = n_top - G * W_seg
        if pad:
            pieces[0].append(jnp.full((pad,), infk(dt), dt))
            pieces[1].append(jnp.zeros((pad,), jnp.int32))
            pieces[2].append(jnp.zeros((pad,), jnp.int32))
        shard_arrs.append(sort_index(jnp.concatenate(pieces[0]),
                                     jnp.concatenate(pieces[1]),
                                     jnp.concatenate(pieces[2])))
    ih = jnp.stack([a[0] for a in shard_arrs])
    irid = jnp.stack([a[1] for a in shard_arrs])
    ips = jnp.stack([a[2] for a in shard_arrs])
    mo = _mid_occ_sharded(ih, mid_occ_fixed, mid_occ_frac)
    bnd = _bnd_ck(ih, S=S, kb=kb,
                  n_bnd=min(_N_BND, max((S * n_top) // 1024, 1)))
    return {"ih": ih, "irid": irid, "ips": ips, "mid_occ": mo,
            "n_idx": S * n_top, "n_shards": S, "bnd_ck": bnd,
            "kb": kb}


def _run_tile(t, k, w, full_width=False):
    wide = 2 * k > 30
    return tile_flat(
        jnp.asarray(t.codes2), jnp.asarray(t.nmask),
        jnp.asarray(t.startmask), jnp.asarray(t.endmask),
        jnp.asarray(t.starts), jnp.asarray(t.gids),
        jnp.asarray(t.used),
        R=t.R, W=t.W, k=k, w=w, full_width=full_width, wide=wide)


def _merge_chunks(chunks, n_idx_sizes):
    """Combine the tiles' flat (hash, rid, pos) chunks into one sorted
    canonical-width index: concatenate, sentinel-pad to the smallest
    fitting canonical width, sort once (sort_index). Replaces the
    pairwise merge-path tree; the only large program is the one
    canonical-width sort."""
    n_slots = sum(int(c[0].shape[0]) for c in chunks)
    n_idx = next((s for s in n_idx_sizes if n_slots <= s), None)
    if n_idx is None:
        # part larger than the canonical index width (~48 Mbp of target
        # sequence at the production geometry): the caller falls back
        # to the exact host index for this part (see ROADMAP capacity
        # note; reference parts are bounded by -I, longQC.py:222-231)
        raise IndexOverflowError(
            "part exceeds the largest canonical index size")
    dt = chunks[0][0].dtype
    ehs = [c[0] for c in chunks]
    ers = [c[1] for c in chunks]
    eps = [c[2] for c in chunks]
    if n_slots < n_idx:
        pad = n_idx - n_slots
        ehs.append(jnp.full((pad,), infk(dt), dt))
        ers.append(jnp.zeros((pad,), jnp.int32))
        eps.append(jnp.zeros((pad,), jnp.int32))
    final = list(sort_index(jnp.concatenate(ehs), jnp.concatenate(ers),
                            jnp.concatenate(eps)))
    return final, n_idx


@jax.jit
def runlen_sorted(ih):
    """Ascending per-key occurrence counts of the sorted hash array,
    INF-padded past n_keys, plus n_keys — via two 1-D sorts and
    elementwise ops only (no scan/scatter run-length pass, and no pull
    of the hashes to the host).

    Derivation: run starts (ih[i] != ih[i-1]) compact to the front by
    sorting their positions; each run's length is the gap to the next
    start (or to n_valid for the last run). Sorting those lengths
    yields exactly the host spec's np.partition view of the count
    multiset (overlap_host.MinimizerIndex.mid_occ; index.c:123-144)."""
    N = ih.shape[0]
    BIG = jnp.int32(0x7FFFFFFF)
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = ih != infk(ih.dtype)
    prev = jnp.concatenate([jnp.full((1,), -1, ih.dtype), ih[:-1]])
    is_start = valid & (ih != prev)
    n_keys = jnp.sum(is_start).astype(jnp.int32)
    n_valid = jnp.sum(valid).astype(jnp.int32)
    sp = jnp.sort(jnp.where(is_start, idx, BIG))
    nxt = jnp.concatenate([sp[1:], jnp.full((1,), BIG, jnp.int32)])
    rl = jnp.where(sp != BIG, jnp.minimum(nxt, n_valid) - sp, BIG)
    return jnp.sort(rl), n_keys


@functools.partial(jax.jit, static_argnames=("frac",))
def _mid_occ_device(ih, *, frac):
    rl_sorted, n_keys = runlen_sorted(ih)
    kth = jnp.maximum(kth_of(n_keys, frac=frac), 0)
    mo = jax.lax.dynamic_slice(rl_sorted, (kth,), (1,))[0] + 1
    # empty part: the host spec's empty-index mid_occ is 1
    return jnp.where(n_keys == 0, jnp.int32(1), mo)


def _mid_occ(ih, mid_occ_fixed, mid_occ_frac):
    if mid_occ_fixed:
        return jnp.asarray(np.int32(mid_occ_fixed))
    return _mid_occ_device(ih, frac=mid_occ_frac)


def _redo_tiles(part, tiles, ovf_np, k, w):
    """Rebuild flat chunks for tiles whose rows overflowed (rare:
    adversarial periodic reads). Overflowing rows re-run one read per
    tile row at full width; clean rows repack normally."""
    sep = max(w - 1, 1)
    chunks = []
    for t, (row_ov, exp_ov) in zip(tiles, ovf_np):
        if not (exp_ov or row_ov[:len(t.used)].any()):
            continue
        bad_rows = set(np.nonzero(row_ov)[0].tolist())
        keep, redo = [], []
        for r in range(t.R):
            gg = [g for g in t.gids[r] if g >= 0]
            (redo if (r in bad_rows) else keep).extend(gg)
        if exp_ov:
            # expansion overflow: conservatively redo every read of
            # this tile at full width (cannot attribute rows)
            redo = keep + redo
            keep = []
        if keep:
            b = _TileBuilder(t.R, t.W, sep)
            for g in keep:
                b.add(g, part[g][1])
            for t2 in b.tiles():
                r2 = _run_tile(t2, k, w)
                if bool(np.asarray(r2[5])) or np.asarray(r2[4]).any():
                    raise IndexOverflowError()
                chunks.append(list(r2[:3]))
        for g in redo:
            b = _TileBuilder(1, t.W, sep)
            b.add(g, part[g][1])
            for t2 in b.tiles():
                r2 = _run_tile(t2, k, w, full_width=True)
                if bool(np.asarray(r2[5])):
                    raise IndexOverflowError()
                chunks.append(list(r2[:3]))
    return chunks


CROP_NUM, CROP_DEN = 3, 8


def _crop_chunk(c):
    """Slice a per-tile sorted chunk to a FIXED 3/8 of its slots (real
    entries are the sorted prefix; the tail is sentinel padding).
    Typical minimizer density is 2/(w+1) ~ 1/3 of columns, so 3/8
    holds every real entry with ~12% headroom; the caller validates
    n_exp <= crop at its deferred sync and recombines with full
    chunks in the rare overflow case. The fraction is static so the
    combine program's shapes depend only on the tile count (a
    data-dependent crop would recompile the combine for every new
    dataset). Cropping keeps the canonical width tracking real
    entries."""
    n = c[0].shape[0]
    crop = max((n * CROP_NUM) // CROP_DEN, min(n, 1024))
    crop = min(-(-crop // 1024) * 1024, n)
    if crop == n:
        return c, n
    return [a[:crop] for a in c], crop


def build_device_index(part, k, w, *, ladder=TILE_LADDER,
                       n_idx_sizes=N_IDX_SIZES, mid_occ_fixed=0,
                       mid_occ_frac=2e-4, max_shards=MAX_SHARDS):
    """Build the sorted device index for one part. Returns a dict with
    ih/irid/ips, mid_occ (device scalar), n_idx, n_tiles, n_shards.

    Parts whose entries fit one canonical width get the 1-D layout
    (n_shards == 1). Bigger parts (the reference contract is -I 4G
    parts, minimap2-coverage.c:266-269) get the hash-range-sharded
    layout from build_sharded_from_chunks: ih/irid/ips are (S, N_top)
    stacks whose flattened order is globally sorted under the virtual
    key ck(pos) = (pos >> log2(N_top)) << kb | min(h, 2^kb) — see
    _shard_ck_note. Every device program involved stays at the
    canonical widths.

    The whole chain — tiles, static 3/8 chunk crops, canonical sort,
    mid_occ — is dispatched optimistically before the overflow flags
    and real entry counts are pulled (crop overflow needs unusual
    minimizer density, row overflow adversarial periodic reads), so
    the build's one host sync sits after every dispatch. On overflow the affected tiles re-run at
    full width / uncropped and the combine chain is re-dispatched."""
    tiles, jumbo = pack_part_tiles(part, w, ladder=ladder)
    tiles = tiles + jumbo
    results = [_run_tile(t, k, w) for t in tiles]
    cropped = [_crop_chunk(list(r[:3])) for r in results]
    n_slots_total = sum(int(c[0].shape[0]) for c, _n in cropped)
    big = n_slots_total > n_idx_sizes[-1]
    final = mo = None
    if not big:
        final, n_idx = _merge_chunks([c for c, _n in cropped],
                                     n_idx_sizes)
        mo = _mid_occ(final[0], mid_occ_fixed, mid_occ_frac)
    for r in results:
        for arr in (r[3], r[4], r[5]):
            try:
                arr.copy_to_host_async()
            except AttributeError:
                pass

    # one deferred sync per part: overflow flags + real entry counts
    # (validates the static crops)
    ovf_np = [(np.asarray(r[4]), bool(np.asarray(r[5])))
              for r in results]
    n_exp = [int(np.asarray(r[3])) for r in results]
    overflow = any(ov or row[:len(t.used)].any()
                   for t, (row, ov) in zip(tiles, ovf_np))
    crop_bad = any(n > crop for n, (_c, crop) in zip(n_exp, cropped))
    if overflow or crop_bad or big:
        redone = _redo_tiles(part, tiles, ovf_np, k, w) \
            if overflow else []
        chunks = []
        for i, r in enumerate(results):
            row, ov = ovf_np[i]
            if ov or row[:len(tiles[i].used)].any():
                continue   # covered by redone
            c, crop = cropped[i]
            chunks.append(list(r[:3]) if n_exp[i] > crop else c)
        chunks += redone
        n_slots_total = sum(int(c[0].shape[0]) for c in chunks)
        if n_slots_total > n_idx_sizes[-1]:
            out = build_sharded_from_chunks(
                chunks, k, n_top=n_idx_sizes[-1],
                mid_occ_fixed=mid_occ_fixed, mid_occ_frac=mid_occ_frac,
                max_shards=max_shards)
            out["n_tiles"] = len(tiles)
            return out
        final, n_idx = _merge_chunks(chunks, n_idx_sizes)
        mo = _mid_occ(final[0], mid_occ_fixed, mid_occ_frac)

    ih, irid, ips = final
    return {"ih": ih, "irid": irid, "ips": ips, "mid_occ": mo,
            "n_idx": n_idx, "n_tiles": len(tiles), "n_shards": 1}
