"""The XLA sketch path (device_index.tile_flat and ops/sketch's
sketch_batch, as the engine runs them) vs the oracle
tests/oracles/sketch_ref.py, on the inputs that stress it: N resets,
tiny reads, (AT)n runs whose k-mers tie with their reverse complement,
and dense multi-read tile rows. Both sides reduce to per-read
multisets of (hash, pos, strand) with multiplicity."""

import numpy as np
import pytest

from longqc_tpu.engine import device_index as di
from longqc_tpu.ops.chain_ring import INF32
from oracles.sketch_ref import sketch as ref_sketch


def _rand_seq(rng, n, with_n=0.0):
    s = rng.choice(list("ACGT"), size=n)
    if with_n:
        s[rng.random_sample(n) < with_n] = "N"
    return "".join(s)


def _tile_for(reads, w, R, W):
    b = di._TileBuilder(R, W, max(w - 1, 1))
    for gid, r in enumerate(reads):
        b.add(gid, r[1])
    tiles = b.tiles()
    assert len(tiles) == 1
    return tiles[0]


def _tile_entries(t, k, w):
    """Per-read {gid: sorted [(hash, local_pos, strand) x mult]} from
    the tile program's sorted flat (hash, rid, pos << 1 | strand)."""
    ih, irid, ips, _n, row_ov, exp_ov = di._run_tile(t, k, w)
    assert not np.asarray(row_ov)[:len(t.used)].any()
    assert not bool(np.asarray(exp_ov))
    ih, irid, ips = (np.asarray(a) for a in (ih, irid, ips))
    out = {}
    for h, g, p in zip(ih, irid, ips):
        if h == INF32:
            continue
        out.setdefault(int(g), []).append(
            (int(np.uint32(h)), int(p) >> 1, int(p) & 1))
    return {g: sorted(v) for g, v in out.items()}


def _oracle(seq, k, w):
    mask = (1 << (2 * k)) - 1
    return sorted(((int(x) >> 8) & mask, (int(y) >> 1) & 0x7FFFFFFF,
                   int(y) & 1) for x, y in ref_sketch(seq, w, k))


@pytest.mark.parametrize("k,w", [(12, 5), (15, 5), (15, 10)])
def test_xla_sketch_matches_oracle(k, w):
    rng = np.random.RandomState(17)
    reads = []
    for i in range(40):
        n = rng.randint(60, 420)
        reads.append(["r%d" % i, _rand_seq(rng, n)])
    # a few reads with Ns and short reads
    for i in range(6):
        reads.append(["n%d" % i, _rand_seq(rng, 200, with_n=0.05)])
    reads.append(["tiny", _rand_seq(rng, k + 2)])
    got = _tile_entries(_tile_for(reads, w, R=4, W=4096), k, w)
    for gid, r in enumerate(reads):
        assert got.get(gid, []) == _oracle(r[1], k, w), gid


def test_xla_sketch_long_symmetric_runs():
    """(AT)n k-mers are their own reverse complement for even k: long
    runs of strand-ambiguous ties, in a tile row and in the query-group
    sketch (sketch_batch)."""
    import jax.numpy as jnp

    from longqc_tpu.io.pack import pack_reads
    from longqc_tpu.ops.sketch import sketch_batch

    k, w = 12, 5
    rng = np.random.RandomState(3)
    good = _rand_seq(rng, 500)
    bad = _rand_seq(rng, 150) + "AT" * 200 + _rand_seq(rng, 150)
    got = _tile_entries(_tile_for([["g", good], ["b", bad]], w, R=1,
                                  W=4096), k, w)
    assert got[0] == _oracle(good, k, w)
    assert got[1] == _oracle(bad, k, w)

    batch = pack_reads([["g", good, ""], ["b", bad, ""]], max_len=1024,
                       pad_to=1024, with_quals=False)
    res = sketch_batch(jnp.asarray(batch.codes),
                       jnp.asarray(batch.lengths), w=w, k=k)
    for row, seq in enumerate((good, bad)):
        emit = np.asarray(res["emit"][row])
        ent = []
        for j in np.nonzero(emit > 0)[0]:
            ent.extend([(int(np.asarray(res["hash"][row][j])),
                         int(np.asarray(res["pos"][row][j])),
                         int(np.asarray(res["strand"][row][j])))]
                       * int(emit[j]))
        assert sorted(ent) == _oracle(seq, k, w), row


def test_xla_sketch_multiread_rows_vs_oracle():
    """Dense multi-read rows (24 reads over 2 rows): every read's
    entries come back attributed to it, equal to its own sketch."""
    k, w = 12, 5
    rng = np.random.RandomState(29)
    reads = [["q%d" % i, _rand_seq(rng, rng.randint(80, 300))]
             for i in range(24)]
    t = _tile_for(reads, w, R=2, W=4096)
    assert (np.asarray(t.gids) >= 0).sum(axis=1).min() > 1
    got = _tile_entries(t, k, w)
    for gid, r in enumerate(reads):
        assert got.get(gid, []) == _oracle(r[1], k, w), gid


@pytest.mark.parametrize("k,w", [(12, 5), (15, 10)])
def test_tile_flat_matches_oracle_small_ladder(k, w):
    """Every tile of the small ladder: the flat (hash, rid, pos)
    triples equal the oracle's, read for read."""
    from test_device_index import _rand_reads

    rng = np.random.RandomState(19)
    part = _rand_reads(rng, 50, 30, 1500)
    tiles, jumbo = di.pack_part_tiles(part, w,
                                      ladder=di.TILE_LADDER_SMALL)
    assert not jumbo
    got = {}
    for t in tiles:
        got.update(_tile_entries(t, k, w))
    for gid, r in enumerate(part):
        assert got.get(gid, []) == _oracle(r[1], k, w), gid


def test_engine_rows_with_symmetric_runs():
    """End-to-end device engine on a genome with a long (AT)n run:
    rows equal the host spec."""
    from util_synth import make_genome, sample_reads
    from longqc_tpu.config import OverlapConfig, IndexOpt, MapOpt, FltOpt
    from longqc_tpu.engine import overlap_host as oh
    from longqc_tpu.engine.device_overlap import overlap_run_device2

    rng = np.random.RandomState(31)
    genome = make_genome(rng, 15000) + "AT" * 400 + make_genome(rng, 4000)
    reads = sample_reads(rng, genome, 70, min_len=600, max_len=1800,
                         err=0.1, junk_frac=0.08)
    queries = reads[:24]
    cfg = OverlapConfig(index=IndexOpt(k=12, w=5),
                        map=MapOpt(min_score_med=80, min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    rows_host = oh.overlap_run(list(reads), queries, cfg)
    rows_dev = overlap_run_device2(list(reads), queries, cfg)
    assert rows_dev == rows_host
