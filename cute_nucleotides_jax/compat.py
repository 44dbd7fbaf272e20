"""Drop-in compatibility surface: the reference's 13 function names.

A user of the reference crate (``cute_nucleotides::n_to_bits::*``,
``::n_to_bits2::*``; reference src/lib.rs:1-2) can import these and get the
same names, signatures (bytes in / u64 words out, explicit decode length) and
bit-identical results.  Each x86-variant name maps to the device variant
that fills its architectural slot.

Every name maps to a DISTINCT mechanism (no two names alias one
implementation, mirroring the reference's genuinely different algorithms):

================== =======================================================
reference name     this framework
================== =======================================================
n_to_bits_lut      scalar oracle (C++ native when available)
n_to_bits_pext     XLA ``dot`` — power-of-4-weighted sum of the codes (the
                   bit-gather slot of pext)
n_to_bits_shift    XLA ``shift`` (log-depth shift-OR tree)
n_to_bits_movemask XLA ``interleave`` (even/odd plane split + fold — the
                   unpacklo/hi + movemask dataflow)
n_to_bits_mul      XLA ``mul`` (multiply-as-bit-shuffle, direct port)
bits_to_n_lut      scalar oracle
bits_to_n_shuffle  XLA ``shuffle`` (packed-LUT variable shift)
bits_to_n_pdep     XLA ``swar`` (masked spread-multiplies — the direct
                   descendant of pdep's bit spread)
bits_to_n_clmul    XLA ``select`` (arithmetic select tree)
n_to_bits2_lut     scalar oracle
n_to_bits2_pext    XLA triplet mul-add + shift-OR encoder
bits_to_n2_lut     scalar oracle
bits_to_n2_pdep    XLA multiply-shift digit decoder
================== =======================================================

Use the device API (:mod:`.models`) for production throughput.
"""

from __future__ import annotations

import numpy as np

from . import api
from .ops import native

__all__ = [
    "n_to_bits_lut", "n_to_bits_pext", "n_to_bits_shift",
    "n_to_bits_movemask", "n_to_bits_mul",
    "bits_to_n_lut", "bits_to_n_shuffle", "bits_to_n_pdep", "bits_to_n_clmul",
    "n_to_bits2_lut", "n_to_bits2_pext", "bits_to_n2_lut", "bits_to_n2_pdep",
]


def n_to_bits_lut(n) -> np.ndarray:
    return native.n_to_bits(n)


def n_to_bits_pext(n) -> np.ndarray:
    return api.n_to_bits(n, tier="xla", variant="dot")


def n_to_bits_shift(n) -> np.ndarray:
    return api.n_to_bits(n, tier="xla", variant="shift")


def n_to_bits_movemask(n) -> np.ndarray:
    return api.n_to_bits(n, tier="xla", variant="interleave")


def n_to_bits_mul(n) -> np.ndarray:
    return api.n_to_bits(n, tier="xla", variant="mul")


def bits_to_n_lut(bits, length: int) -> np.ndarray:
    return native.bits_to_n(bits, length)


def bits_to_n_shuffle(bits, length: int) -> np.ndarray:
    return api.bits_to_n(bits, length, tier="xla", variant="shuffle")


def bits_to_n_pdep(bits, length: int) -> np.ndarray:
    return api.bits_to_n(bits, length, tier="xla", variant="swar")


def bits_to_n_clmul(bits, length: int) -> np.ndarray:
    return api.bits_to_n(bits, length, tier="xla", variant="select")


def n_to_bits2_lut(n) -> np.ndarray:
    return native.n_to_bits2(n)


def n_to_bits2_pext(n) -> np.ndarray:
    return api.n_to_bits2(n, tier="xla")


def bits_to_n2_lut(bits, length: int) -> np.ndarray:
    return native.bits_to_n2(bits, length)


def bits_to_n2_pdep(bits, length: int) -> np.ndarray:
    return api.bits_to_n2(bits, length, tier="xla")
