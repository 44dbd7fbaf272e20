"""User-facing codec API, mirroring the reference's function menu.

The reference exposes 13 free functions (5 + 4 two-bit, 2 + 2 base-5;
reference src/lib.rs:1-2).  This framework exposes the same four logical
operations, each with a *tier* (``oracle`` scalar spec / ``xla`` whole-array
device kernel) and, for the 2-bit codec, a *variant* selecting the packing
strategy — the device analogue of the reference's five-encoder/four-decoder
menu.

These functions take host ``bytes``/NumPy arrays and return NumPy arrays with
the reference's exact semantics (u64 packed words, explicit decode length).
For the high-throughput device-array path use
:class:`cute_nucleotides_jax.models.TwoBitCodec` /
:class:`cute_nucleotides_jax.models.Base5Codec` directly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .ops import oracle, spec, xla

__all__ = ["n_to_bits", "bits_to_n", "n_to_bits2", "bits_to_n2"]

#: device-dispatch tiers these entry points accept ("auto" resolves per
#: backend); the host C++ tier is its own surface: ``ops.native.n_to_bits``
_TIERS = ("oracle", "xla", "auto")


def _check_tier(tier: str) -> str:
    if tier not in _TIERS:
        hint = (
            " (the host C++ tier is driven via ops.native.*)"
            if tier == "native"
            else ""
        )
        raise ValueError(f"unknown tier {tier!r}; expected one of {_TIERS}{hint}")
    if tier == "auto":
        from .models import _default_tier

        return _default_tier()
    return tier


#: one bytes->uint8 coercer for the whole package (r05 review: three
#: near-identical copies drifted across api/oracle/native)
_as_u8 = oracle._as_u8


def _pad_to(a: np.ndarray, block: int, fill: int = ord("A")) -> np.ndarray:
    """Pad to a *bucketed* block-multiple length.

    Device calls compile per shape, so arbitrary read lengths would trigger a
    compilation each; bucketing to the next power-of-two block count bounds
    the number of compiled shapes to ~log2(max_len) while output words beyond
    the logical count are sliced off by the callers.
    """
    blocks = max(-(-a.size // block), 1)
    bucket = 1 << (blocks - 1).bit_length()
    target = bucket * block
    if target == a.size:
        return a
    return np.concatenate([a, np.full(target - a.size, fill, dtype=np.uint8)])


def _bucket_words(bits: np.ndarray) -> np.ndarray:
    """Zero-pad a u64 word stream to the next power-of-two count (the
    decode-side mirror of _pad_to's shape bucketing)."""
    bucket = 1 << (bits.size - 1).bit_length()
    if bucket != bits.size:
        bits = np.concatenate([bits, np.zeros(bucket - bits.size, np.uint64)])
    return bits


@functools.lru_cache(maxsize=None)
def _jit_encode_2bit(variant: str):
    return jax.jit(functools.partial(xla.encode_2bit_words, variant=variant))


@functools.lru_cache(maxsize=None)
def _jit_decode_2bit(variant: str):
    return jax.jit(functools.partial(xla.decode_2bit_bytes, variant=variant))


@functools.lru_cache(maxsize=None)
def _jit_encode_b5():
    return jax.jit(xla.encode_b5_words)


@functools.lru_cache(maxsize=None)
def _jit_decode_b5():
    return jax.jit(xla.decode_b5_bytes)


def _validate_input(seq: np.ndarray, allow_n: bool) -> None:
    """Raise on the first byte outside the codec alphabet (host-side C++
    scan — for single reads this beats a device round-trip; batch pipelines
    get the device-FUSED check via the models/runtime encode_checked)."""
    from .ops import native

    pos = native.find_invalid(seq, allow_n=allow_n)
    if pos >= 0:
        raise ValueError(
            f"invalid byte {bytes(seq[pos:pos + 1])!r} at position {pos} "
            f"(alphabet: ACGTU{'N' if allow_n else ''}, either case)"
        )


def n_to_bits(
    seq, *, tier: str = "xla", variant: str | None = None,
    validate: bool = False,
) -> np.ndarray:
    """Encode {A,C,G,T/U} bytes to 2-bit packed u64 words (LSB-first).

    Bit-exact to the reference's encoders (reference src/n_to_bits.rs:34-259).
    ``variant=None`` resolves to the tier's fastest form ("mul" on xla);
    see models.CodecConfig.
    ``validate=True`` raises ``ValueError`` on out-of-alphabet input (the
    reference leaves it UB; unvalidated encode here uses the defined
    ``(byte >> 1) & 3`` contract).
    """
    tier = _check_tier(tier)
    n = _as_u8(seq)
    if validate:
        _validate_input(n, allow_n=False)
    if variant is None:
        from .models import default_encode_variant

        variant = default_encode_variant(tier)
    if tier == "oracle":
        return oracle.n_to_bits_lut(n)
    if n.size == 0:
        return np.zeros(0, dtype=np.uint64)
    x = _pad_to(n, spec.NT_PER_WORD_2BIT)
    w32 = np.asarray(_jit_encode_2bit(variant)(jnp.asarray(x)))
    return spec.u32_pairs_to_u64(w32)[: spec.num_words_2bit(n.size)]


def bits_to_n(bits, length: int, *, tier: str = "xla", variant: str | None = None) -> np.ndarray:
    """Decode 2-bit packed u64 words to ASCII; ``length`` = nucleotide count.

    Raises ``ValueError`` on capacity overflow (reference panic,
    src/n_to_bits.rs:52-54).  ``variant=None`` resolves to the tier's
    fastest form ("swar" on xla); see models.CodecConfig.
    """
    tier = _check_tier(tier)
    if variant is None:
        from .models import default_decode_variant

        variant = default_decode_variant(tier)
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if not 0 <= length <= bits.size * spec.NT_PER_WORD_2BIT:
        raise ValueError(
            f"length {length} outside [0, {bits.size * spec.NT_PER_WORD_2BIT}]"
        )
    if tier == "oracle":
        return oracle.bits_to_n_lut(bits, length)
    if bits.size == 0:
        return np.zeros(0, dtype=np.uint8)
    bits = _bucket_words(bits)
    w32 = jnp.asarray(spec.u64_to_u32_pairs(bits).reshape(-1))
    out = np.asarray(_jit_decode_2bit(variant)(w32))
    return out[:length]


def n_to_bits2(seq, *, tier: str = "xla", validate: bool = False) -> np.ndarray:
    """Encode {A,C,G,T/U,N} bytes to base-5 packed u64 words.

    Bit-exact to the reference (reference src/n_to_bits2.rs:37-189).
    ``validate=True`` raises ``ValueError`` on out-of-alphabet input.
    """
    tier = _check_tier(tier)
    n = _as_u8(seq)
    if validate:
        _validate_input(n, allow_n=True)
    if tier == "oracle":
        return oracle.n_to_bits2_lut(n)
    if n.size == 0:
        return np.zeros(0, dtype=np.uint64)
    x = _pad_to(n, spec.NT_PER_WORD_B5)
    fn = _jit_encode_b5()
    w32 = np.asarray(fn(jnp.asarray(x)))
    return spec.u32_pairs_to_u64(w32)[: spec.num_words_b5(n.size)]


def bits_to_n2(bits, length: int, *, tier: str = "xla") -> np.ndarray:
    """Decode base-5 packed u64 words to ASCII; ``length`` = nucleotide count.

    Raises ``ValueError`` on capacity overflow (reference panic,
    src/n_to_bits2.rs:78-80).
    """
    tier = _check_tier(tier)
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if not 0 <= length <= bits.size * spec.NT_PER_WORD_B5:
        raise ValueError(
            f"length {length} outside [0, {bits.size * spec.NT_PER_WORD_B5}]"
        )
    if tier == "oracle":
        return oracle.bits_to_n2_lut(bits, length)
    if bits.size == 0:
        return np.zeros(0, dtype=np.uint8)
    bits = _bucket_words(bits)
    fn = _jit_decode_b5()
    w32 = jnp.asarray(spec.u64_to_u32_pairs(bits).reshape(-1))
    out = np.asarray(fn(w32))
    return out[:length]
