"""ctypes bindings for the native FASTA/FASTQ reader.

Builds native/libfastx_native.so on demand (g++ + zlib), again whenever
the source is newer than the library or the library fails to load (so
a library built elsewhere is never used); falls back to the
pure-Python reader when the toolchain is unavailable. The native
reader replaces the reference's kseq-based C readers in the data-loader
role: record lexing runs in C++, while chunk-boundary accounting stays
in Python for bit-compatibility with the reference's chunking.
"""

import ctypes
import os
import subprocess
from logging import getLogger

logger = getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "native")
_SO = os.path.join(_NATIVE_DIR, "libfastx_native.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    lib = None
    for force in (False, True):
        try:
            subprocess.run(["make", "-s"] + (["-B"] if force else []),
                           cwd=_NATIVE_DIR, check=True,
                           capture_output=True, timeout=120)
            lib = ctypes.CDLL(_SO)
            break
        except Exception as e:  # pragma: no cover
            logger.info("native fastx reader unavailable (%s)", e)
    if lib is None:  # pragma: no cover
        return None
    lib.lqf_open.restype = ctypes.c_void_p
    lib.lqf_open.argtypes = [ctypes.c_char_p]
    lib.lqf_next_batch.restype = ctypes.c_long
    lib.lqf_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                   ctypes.c_long]
    for fn in ("lqf_names", "lqf_seqs", "lqf_quals"):
        getattr(lib, fn).restype = ctypes.c_void_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("lqf_name_offs", "lqf_seq_offs"):
        getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_long)
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.lqf_has_qual.restype = ctypes.c_int
    lib.lqf_has_qual.argtypes = [ctypes.c_void_p]
    lib.lqf_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available():
    return _load() is not None


def iter_fastx_native(fn, batch_records=4096, batch_bases=64 * 1024 * 1024):
    """Yield (name, seq, qual_or_None) using the native reader."""
    lib = _load()
    assert lib is not None
    h = lib.lqf_open(fn.encode())
    if not h:
        raise IOError("cannot open %s" % fn)
    try:
        while True:
            n = lib.lqf_next_batch(h, batch_records, batch_bases)
            if n < 0:
                raise ValueError("parse error in %s" % fn)
            if n == 0:
                return
            name_offs = lib.lqf_name_offs(h)
            seq_offs = lib.lqf_seq_offs(h)
            names = ctypes.string_at(lib.lqf_names(h),
                                     name_offs[n]).decode("ascii")
            seqs = ctypes.string_at(lib.lqf_seqs(h), seq_offs[n])
            has_q = lib.lqf_has_qual(h)
            quals = (ctypes.string_at(lib.lqf_quals(h), seq_offs[n])
                     if has_q else None)
            for i in range(n):
                ns, ne = name_offs[i], name_offs[i + 1]
                ss, se = seq_offs[i], seq_offs[i + 1]
                yield (names[ns:ne],
                       seqs[ss:se].decode("ascii"),
                       quals[ss:se].decode("ascii") if has_q else None)
    finally:
        lib.lqf_close(h)
