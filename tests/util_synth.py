"""Synthetic long-read data generation for oracle tests."""

import numpy as np

BASES = "ACGT"


def make_genome(rng, n):
    return "".join(BASES[i] for i in rng.randint(0, 4, size=n))


def revcomp(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    return "".join(comp[c] for c in reversed(s))


def mutate(rng, seq, err=0.1):
    """Apply substitutions/insertions/deletions at uniform rate."""
    out = []
    for ch in seq:
        r = rng.random_sample()
        if r < err * 0.5:       # substitution
            out.append(BASES[rng.randint(0, 4)])
        elif r < err * 0.75:    # deletion
            pass
        elif r < err:           # insertion
            out.append(ch)
            out.append(BASES[rng.randint(0, 4)])
        else:
            out.append(ch)
    return "".join(out)


def sample_reads(rng, genome, n_reads, min_len=800, max_len=3000,
                 err=0.1, rev_frac=0.5, junk_frac=0.0):
    """Simulated reads with quality strings; some pure-junk reads."""
    reads = []
    for i in range(n_reads):
        if rng.random_sample() < junk_frac:
            ln = rng.randint(min_len, max_len)
            seq = make_genome(rng, ln)
        else:
            ln = rng.randint(min_len, max_len)
            start = rng.randint(0, max(1, len(genome) - ln))
            seq = genome[start:start + ln]
            if rng.random_sample() < rev_frac:
                seq = revcomp(seq)
            seq = mutate(rng, seq, err)
        qual = "".join(chr(33 + rng.randint(3, 41)) for _ in range(len(seq)))
        reads.append(["read%05d" % i, seq, qual])
    return reads


def write_fastq_file(path, reads):
    with open(path, "w") as f:
        for name, seq, qual in reads:
            f.write("@%s\n%s\n+\n%s\n" % (name, seq, qual))


def write_fasta_file(path, reads):
    with open(path, "w") as f:
        for r in reads:
            f.write(">%s\n%s\n" % (r[0], r[1]))

def sample_reads_fast(rng, genome, n_reads, min_len=800, max_len=3000,
                      err=0.1, rev_frac=0.5, junk_frac=0.0, lengths=None):
    """Vectorized read simulator for the 100+ Mbp bench scales (the
    per-character sample_reads costs ~20 s per sampled Mread). Same
    read model — substitution/deletion/insertion at err*[0.5/0.25/
    0.25], junk reads, reverse complements — different variate
    stream, so it defines its own scale points. lengths: optional
    per-read template lengths (else uniform in [min_len, max_len))."""
    g = np.frombuffer(genome.encode("ascii"), np.uint8)
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    basesb = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for i in range(n_reads):
        ln = (int(lengths[i]) if lengths is not None
              else rng.randint(min_len, max_len))
        if rng.random_sample() < junk_frac:
            seq = basesb[rng.randint(0, 4, ln)]
        else:
            start = rng.randint(0, max(1, len(g) - ln))
            seq = g[start:start + ln]
            if rng.random_sample() < rev_frac:
                seq = comp[seq[::-1]]
            r = rng.random_sample(ln)
            sub = r < err * 0.5
            dele = (r >= err * 0.5) & (r < err * 0.75)
            ins = (r >= err * 0.75) & (r < err)
            seq = seq.copy()
            seq[sub] = basesb[rng.randint(0, 4, int(sub.sum()))]
            rep = np.ones(ln, np.int64)
            rep[dele] = 0
            rep[ins] = 2
            seq = np.repeat(seq, rep)
        qual = (rng.randint(3, 41, len(seq)) + 33).astype(np.uint8)
        reads.append(["read%05d" % i, seq.tobytes().decode("ascii"),
                      qual.tobytes().decode("ascii")])
    return reads


def make_genome_fast(rng, n):
    """Vectorized genome synthesis (make_genome joins per-character;
    ~25 s at 20 Mbp on this box)."""
    basesb = np.frombuffer(b"ACGT", np.uint8)
    return basesb[rng.randint(0, 4, n)].tobytes().decode("ascii")
