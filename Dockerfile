# longqc_tpu container recipe (the reference ships a miniconda-based
# Dockerfile building minimap2-coverage, /root/reference/Dockerfile:1;
# here the compute path is JAX on an NVIDIA GPU; the native pieces are
# the FASTA/FASTQ reader and the chain-DP CUDA kernels, which build at
# first use on the GPU host from native/chain_ring.cu).
FROM python:3.12-slim

LABEL software="longqc_tpu"

RUN apt-get update && \
    apt-get install -y --no-install-recommends \
        build-essential zlib1g-dev && \
    rm -rf /var/lib/apt/lists/*

WORKDIR /opt/longqc_tpu
COPY pyproject.toml README.md ./
COPY longqc_tpu ./longqc_tpu
COPY native ./native

# plain jax runs the CPU backend; a GPU host adds jax's CUDA plugin and
# the CUDA toolkit (nvcc)
RUN pip install --no-cache-dir .
RUN make -C native

ENTRYPOINT ["longqc-tpu"]
CMD ["--help"]
