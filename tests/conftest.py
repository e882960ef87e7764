import os
import sys

import pytest

# The suite runs on the CPU unless JAX_PLATFORMS says otherwise (so
# `JAX_PLATFORMS=cuda pytest -m gpu` runs the card's tests), on a
# virtual 8-device CPU mesh that validates the sharding logic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(__file__))


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided when the test
    runs, never at import or collection)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: JAX_PLATFORMS=cuda "
                    "python -m pytest tests -m gpu)")
    return jax.devices()[0]
