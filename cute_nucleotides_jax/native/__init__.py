"""Native (C++) host oracle build + ctypes binding.

The shared library is compiled on first use with the system ``g++`` (the
toolchain is a baked-in dependency); the build artifact is cached next to the
source.  If compilation fails (no compiler in a restricted runtime), callers
fall back to the NumPy oracle — see :mod:`cute_nucleotides_jax.ops.native`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "codec.cpp")
_LIB = os.path.join(_HERE, "libcutenuc.so")
_STAMP = _LIB + ".srchash"

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _compile(digest: str) -> None:
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-funroll-loops",
        "-shared",
        "-fPIC",
        _SRC,
        "-o",
        _LIB,
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    with open(_STAMP, "w") as f:
        f.write(digest)


def _stamp_matches(digest: str) -> bool:
    try:
        with open(_STAMP) as f:
            return f.read().strip() == digest
    except OSError:
        return False


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native codec library, or None.

    Rebuilds whenever the *content hash* of ``codec.cpp`` differs from the
    stamp written at build time — mtimes are meaningless after a fresh
    checkout, and a stale or foreign binary (built elsewhere with
    ``-march=native``) must never be trusted as the parity oracle.
    """
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            digest = _src_hash()
            if not os.path.exists(_LIB) or not _stamp_matches(digest):
                _compile(digest)
            lib = ctypes.CDLL(_LIB)
        except (OSError, subprocess.CalledProcessError) as e:  # pragma: no cover
            _build_error = str(e)
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.cutenuc_n_to_bits.argtypes = [u8p, ctypes.c_size_t, u64p]
        lib.cutenuc_n_to_bits.restype = None
        lib.cutenuc_bits_to_n.argtypes = [u64p, ctypes.c_size_t, u8p]
        lib.cutenuc_bits_to_n.restype = None
        lib.cutenuc_n_to_bits2.argtypes = [u8p, ctypes.c_size_t, u64p]
        lib.cutenuc_n_to_bits2.restype = None
        lib.cutenuc_bits_to_n2.argtypes = [u64p, ctypes.c_size_t, u8p]
        lib.cutenuc_bits_to_n2.restype = None
        lib.cutenuc_memcpy.argtypes = [u8p, ctypes.c_size_t, u8p]
        lib.cutenuc_memcpy.restype = None
        lib.cutenuc_find_invalid.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int]
        lib.cutenuc_find_invalid.restype = ctypes.c_longlong
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.cutenuc_fill_rows.argtypes = [
            u8p, i64p, i64p, ctypes.c_size_t, u8p,
            ctypes.c_size_t, ctypes.c_size_t,
        ]
        lib.cutenuc_fill_rows.restype = None
        lib.cutenuc_fastq_scan.argtypes = [
            u8p, ctypes.c_size_t, i64p, i64p, ctypes.c_size_t, i64p,
        ]
        lib.cutenuc_fastq_scan.restype = ctypes.c_longlong
        lib.cutenuc_edit_distance.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
        ]
        lib.cutenuc_edit_distance.restype = ctypes.c_longlong
        lib.cutenuc_best_match.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, i64p, i64p,
        ]
        lib.cutenuc_best_match.restype = None
        lib.cutenuc_prefix_match.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, i64p, i64p,
        ]
        lib.cutenuc_prefix_match.restype = None
        _lib = lib
        return _lib


def build_error() -> str | None:
    return _build_error
