"""The package's one backend decision.

Made once per process from JAX's first device (`jax.devices()[0]`):

  * "gpu": the chain-DP fill and the peak / min-rank ring passes run as
    the CUDA kernels of native/chain_ring.cu (ops/chain_cuda), and the
    index build takes the production tile and index geometry.
  * "cpu": the same passes run as their plain lax.scan forms
    (ops/chain_ring), with the small geometry that keeps the test
    suite's programs small.

Nothing else in the package looks at the platform.
"""

import contextlib
import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class Backend:
    platform: str        # "gpu" or "cpu"
    chain: str           # ring passes: "cuda" kernels or "scan" forms
    geometry: str        # tile / index canonical shapes: "big", "small"


GPU = Backend("gpu", chain="cuda", geometry="big")
CPU = Backend("cpu", chain="scan", geometry="small")

_override = None


@functools.lru_cache(maxsize=None)
def _decide():
    import jax
    platform = jax.devices()[0].platform
    if platform == "gpu":
        return GPU
    if platform == "cpu":
        return CPU
    raise RuntimeError("unsupported JAX platform %r (gpu or cpu)"
                       % platform)


def decide():
    """The Backend this process runs on."""
    return _override or _decide()


@contextlib.contextmanager
def use(**changes):
    """Run a block with fields of the decision replaced, e.g.
    `use(chain="scan")` to time the plain forms on the GPU."""
    global _override
    old = _override
    _override = dataclasses.replace(decide(), **changes)
    try:
        yield _override
    finally:
        _override = old
