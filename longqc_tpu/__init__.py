"""longqc_tpu — long-read quality control as JAX device programs.

A from-scratch reimplementation of the capabilities of LongQC
(reference: yfukasawa/LongQC) for an accelerator (an NVIDIA GPU; the
CPU backend serves the tests): the minimap2-coverage overlap pipeline
(minimizer sketching, seed chaining, coverage accounting) runs as
batched JAX device programs, plus CUDA kernels for the chain DP, over
packed 2-bit read tiles, scaling data-parallel over a `jax.sharding.Mesh`;
statistics (GC, quality, low-complexity masking, length/coverage
distribution fits) are batched array ops; reports (TSV/JSON/HTML/plots)
match the reference's output contracts.

Layout:
    io/        host I/O: format sniffing, FASTA/FASTQ/BAM/FAST5 chunk
               streaming, 2-bit packing, reservoir subsampling
    ops/       device kernels: quality, GC, sdust, sketch, chaining,
               adapter DP, distribution fitting
    engine/    overlap-coverage engine + sampleqc pipeline orchestration
    parallel/  mesh / shard_map data-parallel execution
    report/    coverage analytics, plots, JSON + HTML report
    platform/  per-instrument run QC (RS-II, Sequel, ONT)
"""

import os as _os

import jax

# The sketch kernel packs (w,k)-minimizer hashes into 64-bit lanes for
# k > 16 (2 bits/base, invertible 56-bit hash, cf. reference sketch.c:76).
# Enable x64 so uint64 is available on all backends.
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set (JAX
# reads it itself), otherwise a fixed directory inside the checkout.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache = _os.path.abspath(_os.path.join(
        _os.path.dirname(__file__), _os.pardir, ".cache", "jaxcomp"))
    _os.makedirs(_cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _cache)

from longqc_tpu._version import __version__  # noqa: E402,F401
