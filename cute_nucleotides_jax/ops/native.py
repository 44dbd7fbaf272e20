"""Native-oracle tier: C++ implementations of the four scalar ops.

Same signatures and bit-exact results as :mod:`cute_nucleotides_jax.ops.oracle`
(the NumPy spec tier), but ~100x faster — the practical host oracle for
parity-checking device output at scale and for ragged-tail handling in the
streaming pipeline.  Mirrors the role of the reference's Rust scalar tier
(reference src/n_to_bits.rs:34-69, src/n_to_bits2.rs:37-107).

Falls back to the NumPy oracle transparently when the C++ toolchain is
unavailable (``available()`` reports which path is active).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import oracle, spec
from .. import native as _native_build

__all__ = [
    "available",
    "n_to_bits",
    "bits_to_n",
    "n_to_bits2",
    "bits_to_n2",
    "find_invalid",
    "fill_rows",
    "fastq_scan",
    "memcpy",
    "edit_distance",
    "best_match",
    "prefix_match",
]

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)


def _lib():
    return _native_build.load()


def available() -> bool:
    """True when the compiled C++ oracle is in use (else NumPy fallback)."""
    return _lib() is not None


def _as_u8(seq) -> np.ndarray:
    if isinstance(seq, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    a = np.ascontiguousarray(seq)
    if a.dtype != np.uint8 or a.ndim != 1:
        raise TypeError("expected bytes or 1-D uint8 array")
    return a


def n_to_bits(seq) -> np.ndarray:
    n = _as_u8(seq)
    lib = _lib()
    if lib is None:
        return oracle.n_to_bits_lut(n)
    out = np.empty(spec.num_words_2bit(n.size), dtype=np.uint64)
    lib.cutenuc_n_to_bits(
        n.ctypes.data_as(_u8p), n.size, out.ctypes.data_as(_u64p)
    )
    return out


def bits_to_n(bits, length: int) -> np.ndarray:
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if length > bits.size * spec.NT_PER_WORD_2BIT:
        raise ValueError(
            f"length {length} exceeds capacity {bits.size * spec.NT_PER_WORD_2BIT}"
        )
    lib = _lib()
    if lib is None:
        return oracle.bits_to_n_lut(bits, length)
    out = np.empty(length, dtype=np.uint8)
    lib.cutenuc_bits_to_n(
        bits.ctypes.data_as(_u64p), length, out.ctypes.data_as(_u8p)
    )
    return out


def n_to_bits2(seq) -> np.ndarray:
    n = _as_u8(seq)
    lib = _lib()
    if lib is None:
        return oracle.n_to_bits2_lut(n)
    out = np.empty(spec.num_words_b5(n.size), dtype=np.uint64)
    lib.cutenuc_n_to_bits2(
        n.ctypes.data_as(_u8p), n.size, out.ctypes.data_as(_u64p)
    )
    return out


def bits_to_n2(bits, length: int) -> np.ndarray:
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if length > bits.size * spec.NT_PER_WORD_B5:
        raise ValueError(
            f"length {length} exceeds capacity {bits.size * spec.NT_PER_WORD_B5}"
        )
    lib = _lib()
    if lib is None:
        return oracle.bits_to_n2_lut(bits, length)
    out = np.empty(length, dtype=np.uint8)
    lib.cutenuc_bits_to_n2(
        bits.ctypes.data_as(_u64p), length, out.ctypes.data_as(_u8p)
    )
    return out


def find_invalid(seq, *, allow_n: bool = True) -> int:
    """Index of the first byte outside {A,C,G,T,U[,N]} (case-insensitive), or -1.

    The validation pass the reference lacks (its out-of-alphabet behavior is
    UB, reference src/n_to_bits.rs:42); here it is a first-class optional
    check (see also the device-side validator in ops/validate.py).
    """
    n = _as_u8(seq)
    lib = _lib()
    if lib is None:
        c = n & 0xDF
        ok = (c == ord("A")) | (c == ord("C")) | (c == ord("G"))
        ok |= (c == ord("T")) | (c == ord("U"))
        if allow_n:
            ok |= c == ord("N")
        bad = np.nonzero(~ok)[0]
        return int(bad[0]) if bad.size else -1
    return int(lib.cutenuc_find_invalid(n.ctypes.data_as(_u8p), n.size, int(allow_n)))


def edit_distance(query, text) -> int:
    """Global Levenshtein distance over normalized codes (Myers u64 host
    tier — the latency path for one-off pairs; batches belong on the
    device scan, ops/align.py).  ``N``/``n`` in the *query* matches any
    base, the same wildcard semantics as the device tier."""
    q, t = _as_u8(query), _as_u8(text)
    lib = _lib()
    if lib is None:
        from . import align

        return align.edit_distance_reference(bytes(q), bytes(t))
    return int(
        lib.cutenuc_edit_distance(
            q.ctypes.data_as(_u8p), q.size, t.ctypes.data_as(_u8p), t.size
        )
    )


def best_match(query, text) -> tuple[int, int]:
    """Semiglobal best occurrence ``(dist, end)`` — the host mirror of
    ``align.best_match_packed`` (``(m, 0)`` when nothing beats the
    trivial empty-substring alignment)."""
    q, t = _as_u8(query), _as_u8(text)
    lib = _lib()
    if lib is None:
        from . import align

        return align.best_match_reference(bytes(q), bytes(t))
    d = ctypes.c_int64()
    e = ctypes.c_int64()
    lib.cutenuc_best_match(
        q.ctypes.data_as(_u8p), q.size, t.ctypes.data_as(_u8p), t.size,
        ctypes.byref(d), ctypes.byref(e),
    )
    return int(d.value), int(e.value)


def prefix_match(query, text) -> tuple[int, int]:
    """Prefix (SHW) mode ``(dist, end)``: whole query vs the best text
    PREFIX — the host mirror of ``align.prefix_distance_packed``."""
    q, t = _as_u8(query), _as_u8(text)
    lib = _lib()
    if lib is None:
        from . import align

        if q.size == 0:
            return 0, 0
        return align.prefix_distance_reference(bytes(q), bytes(t))
    d = ctypes.c_int64()
    e = ctypes.c_int64()
    lib.cutenuc_prefix_match(
        q.ctypes.data_as(_u8p), q.size, t.ctypes.data_as(_u8p), t.size,
        ctypes.byref(d), ctypes.byref(e),
    )
    return int(d.value), int(e.value)


def fill_rows(
    buf: np.ndarray, starts: np.ndarray, lens: np.ndarray, out_rows: np.ndarray
) -> None:
    """Scatter parsed reads into padded batch rows (host batch assembly).

    Row ``i < starts.size`` receives ``buf[starts[i] : starts[i]+lens[i]]``
    (truncated at the row width) followed by ``'A'`` padding; remaining rows
    become all-``'A'``.  The C path is one ``memcpy`` + ``memset`` per row —
    the Python per-row slice loop it replaces capped the streaming encoder's
    host stage (utils/io.fastq_batches).
    """
    if out_rows.ndim != 2 or out_rows.dtype != np.uint8:
        raise TypeError("out_rows must be a 2-D uint8 array")
    if not out_rows.flags.c_contiguous:
        raise ValueError("out_rows must be C-contiguous")
    rows, width = out_rows.shape
    cnt = int(starts.size)
    if cnt > rows:
        raise ValueError(f"{cnt} reads for {rows} rows")
    lib = _lib()
    if lib is None:
        pad = ord("A")
        for i in range(cnt):
            li = min(int(lens[i]), width)
            si = int(starts[i])
            out_rows[i, :li] = buf[si : si + li]
            out_rows[i, li:] = pad
        out_rows[cnt:] = pad
        return
    starts64 = np.ascontiguousarray(starts, dtype=np.int64)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    # lens must be checked non-negative BEFORE the span bound: the C side
    # casts to size_t, so a negative len becomes a huge clamped-to-width
    # copy that the min(lens, width) model here would wave through — an
    # out-of-bounds heap read (r05 review)
    if cnt and (
        int(lens64.min()) < 0
        or int(starts64.min()) < 0
        or int((starts64 + np.minimum(lens64, width)).max()) > buf.size
    ):
        raise ValueError("read span out of buffer bounds")
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.cutenuc_fill_rows(
        buf.ctypes.data_as(_u8p),
        starts64.ctypes.data_as(i64p),
        lens64.ctypes.data_as(i64p),
        cnt,
        out_rows.ctypes.data_as(_u8p),
        rows,
        width,
    )


def fastq_scan(buf: np.ndarray):
    """Parse complete 4-line FASTQ records from a chunk buffer.

    Returns ``(starts i64[n], lens i64[n], consumed)`` — sequence-line
    spans (CR already stripped) and the offset past the last complete
    record (the caller carries the remainder) — or ``None`` when the
    native library is unavailable (callers fall back to the NumPy
    newline-indexing parser).  Raises ``ValueError`` on a malformed
    record, matching the NumPy path's framing check.
    """
    lib = _lib()
    if lib is None:
        return None
    if buf.dtype != np.uint8 or buf.ndim != 1:
        raise TypeError("expected a 1-D uint8 chunk buffer")
    cap = buf.size // 6 + 1  # minimum well-formed record is 6 bytes
    starts = np.empty(cap, np.int64)
    lens = np.empty(cap, np.int64)
    consumed = ctypes.c_int64(0)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.cutenuc_fastq_scan(
        buf.ctypes.data_as(_u8p),
        buf.size,
        starts.ctypes.data_as(i64p),
        lens.ctypes.data_as(i64p),
        cap,
        ctypes.byref(consumed),
    )
    if n < 0:
        raise ValueError("malformed FASTQ record")
    return starts[:n], lens[:n], int(consumed.value)


def memcpy(seq) -> np.ndarray:
    """Allocate-and-copy baseline (reference benches/bench_n_to_bits.rs:20)."""
    n = _as_u8(seq)
    out = np.empty(n.size, dtype=np.uint8)
    lib = _lib()
    if lib is None:
        np.copyto(out, n)
        return out
    lib.cutenuc_memcpy(n.ctypes.data_as(_u8p), n.size, out.ctypes.data_as(_u8p))
    return out
