"""XLA codec kernels built from lane-local integer ops.

Design (not a port of the reference's AVX2 code): the accelerator has no
pext/pdep/movemask, so instead of translating the reference's byte-shuffle
tricks every kernel here rests on one observation: after
``lax.bitcast_convert_type(u8[..., 4] -> u32)`` (little-endian) each u32
lane holds **4 consecutive nucleotides**, and both codecs become *fully
lane-local* integer arithmetic:

* 2-bit encode: 4 nt/lane crunch to one packed byte per lane via either a
  log-depth shift-OR tree (analogue of reference src/n_to_bits.rs:121-166
  ``n_to_bits_shift``) or a single multiply-as-bit-shuffle (analogue of
  reference src/n_to_bits.rs:213-259 ``n_to_bits_mul``); 4 packed bytes
  bitcast back to one output u32 (16 nt).
* 2-bit decode: the inverse — bitcast each packed byte into a lane, expand to
  4 ASCII chars with a *variable per-lane shift* into a 4-entry LUT packed in
  a u32 constant (analogue of the shuffle-LUT in reference
  src/n_to_bits.rs:265-303 ``bits_to_n_shuffle``), bitcast out.
* base-5: digit extraction via the packed ``char & 7`` nibble LUT (same ASCII
  property as reference src/n_to_bits2.rs:127-136), triplet ``a + 5b + 25c``
  as an elementwise mul-add (the maddubs analogue, reference
  src/n_to_bits2.rs:160-165), 7-bit packing into u32 pairs via static
  shift-ORs, and decode div/mod-by-5/25 as multiply-shift constant division
  (the Lemire trick of reference src/n_to_bits2.rs:241-247, exact for the
  7-bit triplet domain).

Everything is elementwise / static-strided and integer-only, so XLA fuses
each codec into a single memory-bound pass and the results are exact on
every backend (no floating-point matmul whose precision a backend may
lower).

Shape contracts (enforced, callers pad via :mod:`cute_nucleotides_jax.api`):

* ``encode_2bit_words``:  u8[..., L] -> u32[..., L//16],  L % 16 == 0
* ``decode_2bit_bytes``:  u32[..., W] -> u8[..., W*16]
* ``encode_b5_words``:    u8[..., L] -> u32[..., 2*(L//27)],  L % 27 == 0
* ``decode_b5_bytes``:    u32[..., 2*W] -> u8[..., W*27]

Padding nucleotide is ``A`` (code 0 / digit 0), which makes zero-padding
reproduce the reference's tail semantics exactly (unused high bits zero,
missing triplet digits zero).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import spec, validate

# magic multiplier gathering the four 2-bit codes of a u32 lane into its top
# byte: with t = w & 0x06060606 (code*2 in each byte), bits 24..31 of
# t * MUL_MAGIC are c0 | c1<<2 | c2<<4 | c3<<6 (no cross-term collisions).
MUL_MAGIC = (1 << 5) | (1 << 11) | (1 << 17) | (1 << 23)

#: multiply-shift constants for exact /5 and /25 on the 7-bit triplet domain
DIV5_MUL, DIV5_SHIFT = 205, 10    # t//5  == (t*205) >> 10  for t < 1024
DIV25_MUL, DIV25_SHIFT = 41, 10   # t//25 == (t*41)  >> 10  for t < 1024

ENCODE_2BIT_VARIANTS = ("shift", "mul", "interleave", "dot")
DECODE_2BIT_VARIANTS = ("shuffle", "select", "swar", "broadcast")


def _bytes_to_u32(x: jax.Array) -> jax.Array:
    """u8[..., 4k] -> u32[..., k], little-endian (4 consecutive bytes/lane)."""
    assert x.dtype == jnp.uint8 and x.shape[-1] % 4 == 0
    return jax.lax.bitcast_convert_type(
        x.reshape(*x.shape[:-1], x.shape[-1] // 4, 4), jnp.uint32
    )


def _u32_to_bytes(w: jax.Array) -> jax.Array:
    """u32[..., k] -> u8[..., 4k], little-endian."""
    assert w.dtype == jnp.uint32
    b = jax.lax.bitcast_convert_type(w, jnp.uint8)
    return b.reshape(*w.shape[:-1], w.shape[-1] * 4)


# --- 2-bit codec -----------------------------------------------------------

def pack4_shift(w: jax.Array) -> jax.Array:
    """u32 lane of 4 ASCII nt -> packed byte (low 8 bits), shift-OR tree."""
    t = (w >> 1) & jnp.uint32(0x03030303)
    u = t | (t >> 6)
    return (u | (u >> 12)) & jnp.uint32(0xFF)


def pack4_mul(w: jax.Array) -> jax.Array:
    """u32 lane of 4 ASCII nt -> packed byte, multiply-as-bit-shuffle."""
    t = w & jnp.uint32(0x06060606)
    return (t * jnp.uint32(MUL_MAGIC)) >> 24


def pack4_interleave(w: jax.Array) -> jax.Array:
    """u32 lane of 4 ASCII nt -> packed byte, even/odd interleave (the
    movemask analogue: the even and odd codes split into two planes and
    fold back together)."""
    e = (w >> 1) & jnp.uint32(0x00030003)
    o = (w >> 9) & jnp.uint32(0x00030003)
    m = e | (o << 2)
    return (m | (m >> 12)) & jnp.uint32(0xFF)


def _encode_2bit_dot(x: jax.Array) -> jax.Array:
    """Bitcast-free encode: widen codes and pack 16 per word as one
    power-of-4-weighted sum (the ``maddubs``-as-dot-product idea of
    reference src/n_to_bits2.rs:160-165 applied to the 2-bit codec).

    The weighted fields are disjoint, so the integer sum is the bitwise OR
    of the shifted codes — exact with no floating-point product involved.
    """
    c = ((x >> 1) & jnp.uint8(3)).astype(jnp.uint32)
    g = c.reshape(*c.shape[:-1], c.shape[-1] // 16, 16)
    return jnp.sum(
        g << (2 * jnp.arange(16, dtype=jnp.uint32)), axis=-1, dtype=jnp.uint32
    )


def encode_2bit_words(x: jax.Array, variant: str = "mul") -> jax.Array:
    """Encode u8[..., L] (L % 16 == 0) to packed u32[..., L // 16].

    Each output u32 holds 16 nt LSB-first; viewing the little-endian output
    stream as u64 reproduces the reference's word layout exactly.
    """
    if x.shape[-1] % spec.NT_PER_U32_2BIT:
        raise ValueError(f"last dim {x.shape[-1]} not a multiple of 16")
    if variant == "dot":
        return _encode_2bit_dot(x)
    w = _bytes_to_u32(x)
    packed = {
        "shift": pack4_shift, "mul": pack4_mul, "interleave": pack4_interleave
    }[variant](w)
    return _bytes_to_u32(packed.astype(jnp.uint8))


def _codes_to_chars_shuffle(c: jax.Array) -> jax.Array:
    """2-bit codes -> ASCII via variable shift into a packed u32 LUT."""
    return (jnp.uint32(spec.BITS_TO_CHAR_2BIT_U32) >> (c << 3)) & jnp.uint32(0xFF)


def _codes_to_chars_select(c: jax.Array) -> jax.Array:
    """2-bit codes -> ASCII via an arithmetic select tree (no shifts)."""
    ch = jnp.uint32(ord("A"))
    ch = ch + jnp.where(c == 1, jnp.uint32(2), jnp.uint32(0))
    ch = ch + jnp.where(c == 2, jnp.uint32(19), jnp.uint32(0))
    ch = ch + jnp.where(c == 3, jnp.uint32(6), jnp.uint32(0))
    return ch


def _codes_to_chars_swar(b: jax.Array) -> jax.Array:
    """All 4 chars of a packed byte at once via byte-parallel SWAR: two
    masked spread-multiplies place each 2-bit code in its own byte (the
    pdep descendant), then ``'A' + 2c + 15 [c == 2]`` maps codes to
    A/C/T/G without a table."""
    m1 = (b & jnp.uint32(0x33)) * jnp.uint32((1 << 0) | (1 << 12))
    m2 = (b & jnp.uint32(0xCC)) * jnp.uint32((1 << 6) | (1 << 18))
    s = (m1 | m2) & jnp.uint32(0x03030303)
    e = (s >> 1) & (~s) & jnp.uint32(0x01010101)
    return jnp.uint32(0x41414141) + (s << 1) + e * jnp.uint32(15)


def decode_2bit_bytes(words: jax.Array, variant: str = "swar") -> jax.Array:
    """Decode packed u32[..., W] to ASCII u8[..., W*16] (full blocks).

    Callers truncate to the logical nucleotide count (the packed stream does
    not self-terminate; contract of reference src/n_to_bits.rs:51,150-151).
    """
    if variant == "broadcast":
        # bitcast-free: broadcast each word against the 16 field shifts and
        # narrow to u8
        sh = 2 * jnp.arange(16, dtype=jnp.uint32)
        c = (words[..., None] >> sh) & jnp.uint32(3)
        ch = (jnp.uint32(spec.BITS_TO_CHAR_2BIT_U32) >> (c << 3)) & jnp.uint32(0xFF)
        return ch.astype(jnp.uint8).reshape(
            *words.shape[:-1], words.shape[-1] * 16
        )
    b = _u32_to_bytes(words).astype(jnp.uint32)  # one packed byte (4 nt)/lane
    if variant == "swar":
        return _u32_to_bytes(_codes_to_chars_swar(b))
    to_chars = {
        "shuffle": _codes_to_chars_shuffle,
        "select": _codes_to_chars_select,
    }[variant]
    ch0 = to_chars(b & 3)
    ch1 = to_chars((b >> 2) & 3)
    ch2 = to_chars((b >> 4) & 3)
    ch3 = to_chars((b >> 6) & 3)
    out = ch0 | (ch1 << 8) | (ch2 << 16) | (ch3 << 24)
    return _u32_to_bytes(out)


def encode_2bit_words_checked(
    x: jax.Array, variant: str = "mul"
) -> tuple[jax.Array, jax.Array]:
    """Encode + per-row validity flag: u8[..., L] -> (u32[..., L//16],
    bool[...]); flag row r is True iff it holds a byte outside
    {A,C,G,T,U} (either case).  Both read the same input inside one
    program, so XLA schedules them as one pass over it."""
    return encode_2bit_words(x, variant), jnp.any(~validate.valid_mask(x), axis=-1)


# --- base-5 codec ----------------------------------------------------------

def _digits_b5(x: jax.Array) -> jax.Array:
    """ASCII u8[...] -> base-5 digit u32[...] via the packed nibble LUT."""
    idx = (x & jnp.uint8(7)).astype(jnp.uint32)
    return (jnp.uint32(spec.DIGIT_LUT8_U32) >> (idx << 2)) & jnp.uint32(0xF)


def encode_b5_words(x: jax.Array) -> jax.Array:
    """Encode u8[..., L] (L % 27 == 0) to packed u32[..., 2 * (L // 27)].

    Output u32 pairs are the little-endian halves of the reference's 63-bit
    u64 words (9 triplets x 7 bits, LSB-first; reference
    src/n_to_bits2.rs:49-53).  Triplet 4 straddles the 32-bit boundary: its
    low 4 bits ride ``t4 << 28``'s truncation, its high 3 bits ``t4 >> 4``.
    """
    L = x.shape[-1]
    if L % spec.NT_PER_WORD_B5:
        raise ValueError(f"last dim {L} not a multiple of 27")
    W = L // spec.NT_PER_WORD_B5
    d = _digits_b5(x).reshape(*x.shape[:-1], W, 9, 3)
    t = d[..., 0] + 5 * d[..., 1] + 25 * d[..., 2]  # (..., W, 9) in [0, 125)
    t0, t1, t2, t3, t4, t5, t6, t7, t8 = (t[..., j] for j in range(9))
    lo = t0 | (t1 << 7) | (t2 << 14) | (t3 << 21) | (t4 << 28)
    hi = (t4 >> 4) | (t5 << 3) | (t6 << 10) | (t7 << 17) | (t8 << 24)
    out = jnp.stack([lo, hi], axis=-1)
    return out.reshape(*x.shape[:-1], 2 * W)


def encode_b5_words_checked(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Encode + validity flag: u8[..., L] -> (u32[..., 2*(L//27)], bool
    scalar), True iff ANY byte is outside {A,C,G,T,U,N} (either case)."""
    return encode_b5_words(x), jnp.any(~validate.valid_mask(x, allow_n=True))


def decode_b5_bytes(words: jax.Array) -> jax.Array:
    """Decode packed u32[..., 2*W] to ASCII u8[..., W*27] (full blocks)."""
    if words.shape[-1] % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    W = words.shape[-1] // 2
    pair = words.reshape(*words.shape[:-1], W, 2)
    lo, hi = pair[..., 0], pair[..., 1]
    m7 = jnp.uint32(0x7F)
    t = jnp.stack(
        [
            lo & m7,
            (lo >> 7) & m7,
            (lo >> 14) & m7,
            (lo >> 21) & m7,
            ((lo >> 28) | (hi << 4)) & m7,
            (hi >> 3) & m7,
            (hi >> 10) & m7,
            (hi >> 17) & m7,
            (hi >> 24) & m7,
        ],
        axis=-1,
    )  # (..., W, 9) triplet values in [0, 125)
    # exact multiply-shift division (Lemire analogue; reference
    # src/n_to_bits2.rs:241-247) — no integer divide on the hot path
    q5 = (t * jnp.uint32(DIV5_MUL)) >> DIV5_SHIFT
    q25 = (t * jnp.uint32(DIV25_MUL)) >> DIV25_SHIFT
    d = jnp.stack([t - 5 * q5, q5 - 5 * q25, q25], axis=-1)  # (..., W, 9, 3)
    # digit -> ASCII: 4-entry packed LUT for {A,C,T,G}, select for N
    # (min with 3 keeps the discarded branch's shift amount < 32)
    ch = jnp.where(
        d == 4,
        jnp.uint32(ord("N")),
        (jnp.uint32(spec.BITS_TO_CHAR_2BIT_U32) >> (jnp.minimum(d, 3) << 3))
        & jnp.uint32(0xFF),
    )
    return ch.reshape(*words.shape[:-1], W * spec.NT_PER_WORD_B5).astype(jnp.uint8)
