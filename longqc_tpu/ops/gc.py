"""GC-fraction statistics (cf. lq_gcfrac.LqGC, lq_gcfrac.py:15-48).

Per-read GC fraction plus randomly-placed fixed-size chunk GC fractions
(default 150 bp windows at sample rate 0.2). The reference draws chunk
positions from the *unseeded* global numpy RNG (nondeterministic across
runs); we use a dedicated seeded generator so results are reproducible,
with the same draw structure per read: choice(l, int(l*rate/chunk),
replace=False), breaking at the first index whose window overruns the
read (lq_gcfrac.py:37-47).
"""

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def gc_count_batch(codes, lengths):
    """Per-read GC base count over padded (N, L) code tiles (1=C, 2=G)."""
    pos = jnp.arange(codes.shape[1], dtype=jnp.int32)[None, :]
    mask = pos < lengths[:, None]
    is_gc = ((codes == 1) | (codes == 2)) & mask
    return jnp.sum(is_gc, axis=1, dtype=jnp.int32)


def read_gc_frac_batch(codes, lengths):
    """(gc_counts, gc_fractions): device counts, host f64 division."""
    n_gc = np.asarray(gc_count_batch(codes, lengths))
    frac = n_gc / np.maximum(np.asarray(lengths, dtype=np.float64), 1.0)
    return n_gc, frac


def chunk_gc_fracs(codes_row, length, chunk_size, samp_rate, rng):
    """Sampled fixed-window GC fractions for one read (host).

    Returns (fracs list, gc_total, base_total) matching the reference's
    accumulation including its break-on-overrun quirk.
    """
    n_draw = int((1.0 / chunk_size) * length * samp_rate)
    if n_draw <= 0:
        return [], 0, 0
    idx = rng.choice(length, n_draw, replace=False)
    is_gc = (codes_row[:length] == 1) | (codes_row[:length] == 2)
    cum = np.concatenate([[0], np.cumsum(is_gc, dtype=np.int64)])
    fracs = []
    gc_tot = 0
    tot = 0
    for i in idx:
        if i + chunk_size - 1 > length:
            break
        # i == length - chunk_size + 1 passes the reference's check;
        # its slice seq[i:i + chunk_size] then stops at the read's end
        cgc = int(cum[min(i + chunk_size, length)] - cum[i])
        fracs.append(cgc / chunk_size)
        gc_tot += cgc
        tot += chunk_size
    return fracs, gc_tot, tot


class GCAccumulator:
    """Streaming accumulator over chunks (LqGC-equivalent)."""

    def __init__(self, chunk_size=150, samp_rate=0.2, seed=7):
        self.chunk_size = chunk_size
        self.samp_rate = samp_rate
        self.rng = np.random.RandomState(seed)
        self.r_frac = []
        self.c_frac = []
        self.r_tot = 0
        self.r_gc_tot = 0
        self.c_tot = 0
        self.c_gc_tot = 0

    def add_batch(self, batch):
        """Accumulate from a packed ReadBatch (device per-read GC +
        host chunk sampling)."""
        if batch.n_reads == 0:
            return
        n_gc, frac = read_gc_frac_batch(jnp.asarray(batch.codes),
                                        jnp.asarray(batch.lengths))
        n_gc = np.asarray(n_gc)
        frac = np.asarray(frac)
        self.r_frac.extend(frac.tolist())
        self.r_gc_tot += int(n_gc.sum())
        self.r_tot += int(batch.lengths.sum())
        for i in range(batch.n_reads):
            fr, g, t = chunk_gc_fracs(batch.codes[i], int(batch.lengths[i]),
                                      self.chunk_size, self.samp_rate,
                                      self.rng)
            self.c_frac.extend(fr)
            self.c_gc_tot += g
            self.c_tot += t

    def read_mean_sd(self):
        a = np.asarray(self.r_frac, dtype=np.float64)
        return float(np.mean(a)), float(np.std(a))
