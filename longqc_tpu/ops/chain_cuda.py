"""GPU route of the chain ring passes: native/chain_ring.cu via jax.ffi.

The library is built for sm_90a from the source in the repository into
build/ at the checkout root, at first use (or ahead of time with
`python -m longqc_tpu.ops.chain_cuda`), and rebuilt whenever the source
is newer than the library or the library fails to load. There is no
fallback: on the GPU a library that cannot be built or loaded is an
error.

The wrappers take the layouts of ops/chain_ring's dispatchers: (Q, A)
int32 anchors and outputs, (J, Q) rings, (1, Q) flag words.
"""

import ctypes
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir,
                                     os.pardir))
SRC = os.path.join(_ROOT, "native", "chain_ring.cu")
LIB = os.path.join(_ROOT, "build", "libchain_ring.so")
TARGETS = {"longqc_chain_fill": "LongqcChainFill",
           "longqc_peak_pass": "LongqcPeakPass",
           "longqc_minrank_pass": "LongqcMinRankPass"}

_LOCK = threading.Lock()
_REGISTERED = False


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); it is "
                           "needed to build " + SRC)
    return path


def build(force=False):
    """Compile SRC into LIB unless LIB is newer than SRC; returns LIB."""
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) >= os.path.getmtime(SRC)):
        return LIB
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    tmp = "%s.%d.tmp" % (LIB, os.getpid())
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("building %s failed:\n%s%s"
                           % (SRC, res.stdout, res.stderr))
    os.replace(tmp, LIB)
    return LIB


def _load():
    try:
        return ctypes.cdll.LoadLibrary(build())
    except OSError:
        # a library left by another build environment: rebuild once
        return ctypes.cdll.LoadLibrary(build(force=True))


def register():
    """Build, load and register the FFI targets (once per process)."""
    global _REGISTERED
    with _LOCK:
        if _REGISTERED:
            return
        lib = _load()
        for name, sym in TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, sym)),
                platform="CUDA")
        _REGISTERED = True


def _i32(shape):
    return jax.ShapeDtypeStruct(shape, jnp.int32)


def fill(axh, axl, aq, asp, nb, limbs, rbad, carry, i0, *, J, max_dist,
         bw, max_skip):
    """Chain-DP fill: (Q, A) anchors -> f, p, v (Q, A) + 8-tuple carry."""
    register()
    Q, A = axh.shape
    outs = jax.ffi.ffi_call(
        "longqc_chain_fill",
        [_i32((Q, A))] * 3 + [_i32((J, Q))] * 7 + [_i32((1, Q))])(
        axh, axl, aq, asp, nb.reshape(Q), limbs, rbad.reshape(Q),
        *carry[:7], carry[7].reshape(Q), i0.reshape(1),
        J=np.int32(J), max_dist=np.int32(max_dist), bw=np.int32(bw),
        max_skip=np.int32(max_skip))
    return tuple(outs)


def peak(f, v, p, *, J):
    register()
    return jax.ffi.ffi_call("longqc_peak_pass", _i32(f.shape))(
        f, v, p, J=np.int32(J))


def minrank(p, own_rank, *, J):
    register()
    return jax.ffi.ffi_call("longqc_minrank_pass", _i32(p.shape))(
        p, own_rank, J=np.int32(J))


if __name__ == "__main__":
    print(build(force=True))
