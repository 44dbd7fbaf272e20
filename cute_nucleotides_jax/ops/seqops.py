"""Packed-domain sequence operations: reverse complement and GC content.

These demonstrate the point of the 2-bit format (and of keeping data resident
on device): common genomics primitives become a handful of fused elementwise
ops on the packed stream — no decode pass needed.

* **Complement** is ``code XOR 0b10`` (A<->T is 00<->10, C<->G is 01<->11 —
  the 2-bit code inherits this involution from ASCII bits 1-2), i.e. one
  XOR with ``0xAAAAAAAA`` per packed u32.
* **Reverse** is lane reversal + byteswap + 2-bit-field reversal per byte
  (SWAR), plus a cross-lane funnel shift when the length is not a multiple
  of the word size.
* **GC content**: C (01) and G (11) are exactly the codes with bit 0 set, so
  the count is ``popcount(word & 0x5555...)`` — 'A' padding contributes 0,
  making ragged tails free.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import spec

__all__ = [
    "complement_packed",
    "revcomp_packed",
    "gc_content_packed",
    "gc_bins_packed",
    "gc_content_bytes",
    "base_composition_packed",
    "gc_content_packed_b5",
    "n_count_packed_b5",
    "revcomp_packed_b5",
    "first_invalid_word_b5",
    "packed_slice",
    "packed_concat",
    "packed_slice_b5",
    "packed_concat_b5",
    "translate_packed",
    "translate_6frame",
    "translate_packed_b5",
    "translate_6frame_b5",
    "duplicate_mask",
]


def complement_packed(words: jax.Array) -> jax.Array:
    """Complement every nucleotide of a 2-bit packed u32 stream in place.

    Note: also flips 'A' padding in the tail word to 'T'; pair with a length
    mask (or use :func:`revcomp_packed`, which re-zeroes the tail).
    """
    return words ^ jnp.uint32(0xAAAAAAAA)


def _reverse_within_u32(w: jax.Array) -> jax.Array:
    """Reverse the 16 2-bit fields inside each u32 lane (SWAR)."""
    # byteswap
    w = (
        ((w & jnp.uint32(0xFF)) << 24)
        | ((w & jnp.uint32(0xFF00)) << 8)
        | ((w >> 8) & jnp.uint32(0xFF00))
        | (w >> 24)
    )
    # reverse 2-bit fields within each byte
    return (
        ((w & jnp.uint32(0x03030303)) << 6)
        | ((w & jnp.uint32(0x0C0C0C0C)) << 2)
        | ((w >> 2) & jnp.uint32(0x0C0C0C0C))
        | ((w >> 6) & jnp.uint32(0x03030303))
    )


@functools.partial(jax.jit, static_argnames=("length",))
def revcomp_packed(words: jax.Array, length: int) -> jax.Array:
    """Reverse-complement a 2-bit packed u32[W] stream of ``length`` nt.

    Returns the packed stream of the reverse complement with the same word
    count and zeroed (i.e. 'A'-coded) tail bits, bit-exact to encoding the
    reverse complement of the decoded sequence.
    """
    if words.ndim != 1:
        raise TypeError("revcomp_packed takes a flat u32 word stream")
    W = words.shape[0]
    if length > W * spec.NT_PER_U32_2BIT:
        raise ValueError(f"length {length} exceeds capacity {W * 16}")
    # The reversed stream starts at bit offset 2*(16W - length); shifting
    # the REVERSED stream down by b bits reads neighbor pairs (i, i+1),
    # which is the pair (j, j-1) of the UNREVERSED stream — so run the
    # funnel first and reverse last.  Two structural choices keep this at
    # TWO memory passes (the naive form was 4):
    # * the funnel taps apply the SWAR complement/bit-reversal to both raw
    #   input reads instead of materializing the SWAR'd array (XLA fuses
    #   multi-tap reads of a parameter; a two-tap read of a produced value
    #   forces a materialization pass),
    # * the tail mask always equals the funnel's bit remainder
    #   (2*(16W-len) == -2*len mod 32), so it reduces to masking word 0
    #   BEFORE the reverse (and to nothing when whole lanes shift out).
    lane_sh, bit_sh = divmod(2 * (W * spec.NT_PER_U32_2BIT - length), 32)

    def g(v):
        return _reverse_within_u32(complement_packed(v))

    if bit_sh:
        # the virtual word before the stream must contribute zero bits AFTER
        # g(); g(v) == 0 iff v == 0xAAAAAAAA (all-'T' codes), so pad with that
        prev = jnp.concatenate(
            [jnp.full(1, 0xAAAAAAAA, jnp.uint32), words[:-1]]
        )
        u = (g(words) >> bit_sh) | (g(prev) << (32 - bit_sh))
        if lane_sh == 0:
            # zero the tail beyond `length` (complement turned 'A' pads
            # into 'T'); post-reverse this is the LAST word
            u = u.at[0].set(u[0] & (jnp.uint32(0xFFFFFFFF) >> bit_sh))
    else:
        u = g(words)
    rev = u[::-1]
    if lane_sh:
        rev = jnp.concatenate([rev[lane_sh:], jnp.zeros(lane_sh, jnp.uint32)])
    return rev


def gc_content_packed(words: jax.Array) -> jax.Array:
    """Count of C+G nucleotides per stream: u32[..., W] -> i32[...].

    Codes C (01) and G (11) are exactly those with bit 0 set; 'A' padding
    counts 0, so ragged tails need no masking.
    """
    return jnp.sum(
        jax.lax.population_count(words & jnp.uint32(0x55555555)).astype(
            jnp.int32
        ),
        axis=-1,
    )


@functools.partial(jax.jit, static_argnames=("bin_nt",))
def gc_bins_packed(words: jax.Array, bin_nt: int = 1024) -> jax.Array:
    """Binned GC profile, fully packed: u32[..., W] -> i32[..., ceil(16W/bin)].

    The "GC content per 1 kb window" track (isochores, coverage-bias
    normalization) computed without unpacking positions: each word's GC
    count is one masked popcount (16-nt granularity), and a bin is a
    reshape-sum of ``bin_nt // 16`` word counts — the read stays 0.25
    bytes/nt and the output is ``length / bin_nt`` ints.  ``bin_nt`` must
    be a multiple of 16 so bins align to word boundaries; 'A' padding
    counts 0, so the tail bin is exact without masking (its denominator
    is ``length - 16W' `` — the caller's bookkeeping).
    """
    if bin_nt <= 0 or bin_nt % 16:
        raise ValueError(
            "bin_nt must be a positive multiple of 16 (word alignment)"
        )
    wpb = bin_nt // 16
    W = words.shape[-1]
    pad = (-W) % wpb
    if pad:
        words = jnp.concatenate(
            [
                words,
                jnp.zeros(words.shape[:-1] + (pad,), jnp.uint32),
            ],
            axis=-1,
        )
    per_word = jax.lax.population_count(
        words & jnp.uint32(0x55555555)
    ).astype(jnp.int32)
    return per_word.reshape(words.shape[:-1] + (-1, wpb)).sum(axis=-1)


def base_composition_packed(
    words: jax.Array, length: int | None = None
) -> jax.Array:
    """Per-base counts from a 2-bit packed stream: u32[..., W] -> i32[..., 4]
    in code order (A, C, T, G).

    One masked popcount per base class: with ``hi``/``lo`` the per-field
    code bits, A = ~hi&~lo, C = ~hi&lo, T = hi&~lo, G = hi&lo.  Pass
    ``length`` to subtract the 'A'-coded tail padding from the A column
    (the other classes never see padding).
    """
    hi = (words >> 1) & jnp.uint32(0x55555555)
    lo = words & jnp.uint32(0x55555555)

    def cnt(m):
        return jnp.sum(
            jax.lax.population_count(m).astype(jnp.int32), axis=-1
        )

    field = jnp.uint32(0x55555555)
    out = jnp.stack(
        [
            cnt(~hi & ~lo & field),
            cnt(~hi & lo & field),
            cnt(hi & ~lo & field),
            cnt(hi & lo & field),
        ],
        axis=-1,
    )
    if length is not None:
        pad = words.shape[-1] * spec.NT_PER_U32_2BIT - length
        if pad < 0:
            raise ValueError(f"length {length} exceeds capacity")
        out = out - jnp.asarray([pad, 0, 0, 0], jnp.int32)
    return out


def gc_content_bytes(reads: jax.Array) -> jax.Array:
    """Count of C+G per read from ASCII bytes (case-insensitive)."""
    code = (reads >> 1) & jnp.uint8(3)
    # C=01, G=11 have bit0 set; but T/U (10) and A (00) do not
    return jnp.sum((code & 1).astype(jnp.int32), axis=-1)


# ---------------------------------------------------------------------------
# Base-5 packed-domain ops
# ---------------------------------------------------------------------------
# The same packed-domain principle extends to the base-5 stream (u32 pairs,
# 9 x 7-bit triplets per u64 word, reference src/n_to_bits2.rs:44-53): a
# triplet value t = a + 5b + 25c yields its digits with the exact
# multiply-shift divisions, and the digit space shares the 2-bit code's
# lucky bit: C (1) and G (3) are exactly the digits with bit 0 set while
# A (0), T (2), N (4) are not — so GC content is (digit & 1) summed, and
# encoder padding (digit 0) again contributes nothing.


def _b5_digits(t: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Triplet values -> (a, b, c) digit planes (exact multiply-shift /5, /25
    on the 7-bit domain; reference src/n_to_bits2.rs:241-247)."""
    q5 = (t * 205) >> 10
    q25 = (t * 41) >> 10
    return t - 5 * q5, q5 - 5 * q25, q25


def _b5_lane_parity_reduce(words: jax.Array, per_triplet, combine, init):
    """Single-pass lane-parity walk over a flat interleaved base-5 stream.

    Each even lane (lo half of its u64 word) owns triplets 0-4 — triplet
    4's high bits come from the NEXT lane, read as a parameter multi-tap
    that XLA fuses without materializing — and each odd lane (hi half)
    owns triplets 5-8.  ``per_triplet(t)`` maps each 7-bit triplet value
    (it MUST map triplet 0, i.e. 'AAA', to the ``combine`` identity — the
    odd lanes' fifth slot is zero-filled), ``combine``/``init`` fold the
    per-lane accumulations, and the result is the parity-selected per-lane
    array.  This is the ONLY place the base-5 bit-layout tap table lives
    (shared by the digit counters and the integrity scan); the earlier
    (W, 2) reshape + lo/hi slicing form relayouted the whole stream.

    Shared-tap trick: the odd lanes' triplet offsets (3, 10, 17, 24) are
    the even lanes' offsets (0, 7, 14, 21) applied to ``x >> 3``, so ONE
    parity select shares four of the five triplet extractions across both
    parities — ~1.8x fewer vector ops than folding the two parities
    separately (the first form of this reducer did exactly that).
    """
    if words.shape[-1] % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    m7 = jnp.uint32(0x7F)
    x = words
    nxt = jnp.concatenate(
        [x[..., 1:], jnp.zeros((*x.shape[:-1], 1), jnp.uint32)], axis=-1
    )
    lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    is_even = (lane & 1) == 0
    z = jnp.where(is_even, x, x >> 3)
    acc = init(x.shape)
    for j in range(4):
        acc = combine(acc, per_triplet((z >> (7 * j)) & m7))
    # the fifth triplet exists only on even lanes (its high bits straddle
    # into the next lane); odd lanes contribute the neutral triplet 0
    t4 = jnp.where(is_even, ((x >> 28) | (nxt << 4)) & m7, jnp.uint32(0))
    return combine(acc, per_triplet(t4))


def _b5_digit_class_sum(words: jax.Array, per_digit) -> jax.Array:
    """Sum ``per_digit(d)`` over every digit of a base-5 stream in one
    memory pass (see :func:`_b5_lane_parity_reduce`)."""
    if words.shape[-1] % 2:
        raise ValueError("base-5 packed stream must have even u32 count")

    def per_triplet(t):
        a, b, c = _b5_digits(t.astype(jnp.int32))
        return per_digit(a) + per_digit(b) + per_digit(c)

    acc = _b5_lane_parity_reduce(
        words,
        per_triplet,
        combine=lambda a, v: a + v,
        init=lambda shape: jnp.zeros(shape, jnp.int32),
    )
    return jnp.sum(acc, axis=-1)


def gc_content_packed_b5(words: jax.Array) -> jax.Array:
    """Count of C+G nucleotides per base-5 stream: u32[..., 2W] -> i32[...].

    Digits C (1) and G (3) are exactly those with bit 0 set (A=0, T=2, N=4
    are even), so the count is ``sum((digit & 1))``; 'A' padding counts 0,
    ragged tails need no masking.

    Parity shortcut: with ``u = t // 5 = b + 5c`` and ``v = t // 25 = c``
    for triplet ``t = a + 5b + 25c``, each digit's low bit is an XOR of
    quotients — ``a & 1 = (t ^ u) & 1``, ``b & 1 = (u ^ v) & 1``,
    ``c & 1 = v & 1`` (5d and d share parity) — so the per-triplet count
    needs only the two multiply-shift quotients, no remainders.
    """

    def per_triplet(t):
        t = t.astype(jnp.int32)
        u = (t * 205) >> 10
        v = (t * 41) >> 10
        return ((t ^ u) & 1) + ((u ^ v) & 1) + (v & 1)

    acc = _b5_lane_parity_reduce(
        words,
        per_triplet,
        combine=lambda a, v: a + v,
        init=lambda shape: jnp.zeros(shape, jnp.int32),
    )
    return jnp.sum(acc, axis=-1)


def n_count_packed_b5(words: jax.Array) -> jax.Array:
    """Count of N nucleotides per base-5 stream: u32[..., 2W] -> i32[...].

    N is digit 4, the only digit with bit 2 set: ``sum(digit >> 2)``.
    """
    return _b5_digit_class_sum(words, lambda d: d >> 2)


def _b5_comp(d: jax.Array) -> jax.Array:
    """Complement one digit plane: A(0)<->T(2), C(1)<->G(3), N(4) fixed.

    ``d ^ 2`` for d < 4 — the digit space inherits the 2-bit code's
    XOR-complement involution — and N is its own complement.
    """
    return d ^ jnp.where(d < 4, 2, 0)


def _b5_word_triplet(lo: jax.Array, hi: jax.Array, j: int) -> jax.Array:
    """Triplet ``j`` (0..8) of a u64 word given its (lo, hi) u32 halves."""
    m7 = jnp.uint32(0x7F)
    if j <= 3:
        return (lo >> (7 * j)) & m7
    if j == 4:
        return ((lo >> 28) | (hi << 4)) & m7
    return (hi >> (7 * j - 32)) & m7


@functools.partial(jax.jit, static_argnames=("length",))
def revcomp_packed_b5(words: jax.Array, length: int) -> jax.Array:
    """Reverse-complement a base-5 packed u32[2W] stream of ``length`` nt.

    The packed-domain mirror of :func:`revcomp_packed` for the 27-nt/63-bit
    format (the "same principle extends" claim of this module's base-5
    section, made real): digit complement is ``d ^ 2`` for d < 4 with N (4)
    a fixed point, and reversal renumbers digit positions ``p -> L-1-p``.
    Returns the interleaved u32 pair stream of the reverse complement with
    the same word count, zero tail digits and zero pad bits — bit-exact to
    encoding the reverse complement (with N) of the decoded sequence.

    Single-pass structure (the 2-bit lesson applied): out digit ``m`` is
    ``comp(digit[L-1-m])``, so output triplet ``j`` of output word ``W-1-w``
    reads input triplets ``9w + delta - j`` (and ``-1``) — every tap is a
    lane-shifted read of the raw input *parameter* (which XLA fuses without
    materializing), each lane assembles the half-word its mirror position
    needs, and one lane reversal finishes the job: two memory passes total,
    no (W, 2) planarize relayout.
    """
    if words.ndim != 1 or words.shape[0] % 2:
        raise TypeError("revcomp_packed_b5 takes a flat interleaved u32[2W] stream")
    W_cap = words.shape[0] // 2
    if length > W_cap * spec.NT_PER_WORD_B5:
        raise ValueError(f"length {length} exceeds capacity {W_cap * 27}")
    if W_cap == 0 or length == 0:
        return jnp.zeros_like(words)
    # operate on the EFFECTIVE word count only: with slack capacity
    # (trailing all-zero u64 words) delta below would go negative and
    # src_triplet's q in {-1, 0} routing would read the wrong word (r05
    # review, reproduced) — the reverse complement packs from position 0
    # anyway, so trailing slack words are zeros on both sides
    W = -(-length // spec.NT_PER_WORD_B5)
    M, u = divmod(length - 1, 3)  # last digit lives at digit u of triplet M
    delta = M - 9 * (W - 1)       # in [0, 8] by construction of W
    x = words[: 2 * W]

    def tap(off: int) -> jax.Array:
        """Lane-shifted view: lane k reads ``words[k + off]`` (0 outside)."""
        if off == 0:
            return x
        if abs(off) >= x.shape[0]:  # short streams: everything shifts out
            return jnp.zeros_like(x)
        z = jnp.zeros(abs(off), jnp.uint32)
        return (
            jnp.concatenate([z, x[:off]])
            if off < 0
            else jnp.concatenate([x[off:], z])
        )

    lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, 0)
    even = (lane & 1) == 0
    w_idx = lane >> 1
    # (lo, hi) of this lane's word w and of word w-1, per parity
    t_m3, t_m2, t_m1, t_p1 = tap(-3), tap(-2), tap(-1), tap(1)
    lo_w = jnp.where(even, x, t_m1)
    hi_w = jnp.where(even, t_p1, x)
    lo_w1 = jnp.where(even, t_m2, t_m3)
    hi_w1 = jnp.where(even, t_m1, t_m2)

    def src_triplet(rel: int) -> tuple[jax.Array, jax.Array]:
        """Input triplet ``9w + rel`` as (value, in-range mask 0/1)."""
        q, jj = divmod(rel, 9)  # q in {-1, 0}
        if q == 0:
            t = _b5_word_triplet(lo_w, hi_w, jj)
        else:
            t = _b5_word_triplet(lo_w1, hi_w1, jj)
        # negative global triplet index (only word 0's lanes) reads zeros
        # through the tap padding but must contribute digit 0, not comp(0)
        if rel >= 0:
            mask = jnp.ones_like(t, jnp.uint32)
        else:
            mask = ((9 * w_idx + rel) >= 0).astype(jnp.uint32)
        return t, mask

    def out_triplet(j: int) -> jax.Array:
        """Output triplet ``j`` of output word ``W-1-w``, complemented and
        reversed per the static digit offset ``u``."""
        t1, m1 = src_triplet(delta - j)
        a1, b1, c1 = _b5_digits(t1.astype(jnp.int32))
        if u == 2:
            val = _b5_comp(c1) + 5 * _b5_comp(b1) + 25 * _b5_comp(a1)
            return (val * m1.astype(jnp.int32)).astype(jnp.uint32)
        t2, m2 = src_triplet(delta - j - 1)
        _, b2, c2 = _b5_digits(t2.astype(jnp.int32))
        if u == 1:
            hi_part = 25 * _b5_comp(c2) * m2.astype(jnp.int32)
            lo_part = (_b5_comp(b1) + 5 * _b5_comp(a1)) * m1.astype(jnp.int32)
        else:  # u == 0
            hi_part = (5 * _b5_comp(c2) + 25 * _b5_comp(b2)) * m2.astype(jnp.int32)
            lo_part = _b5_comp(a1) * m1.astype(jnp.int32)
        return (lo_part + hi_part).astype(jnp.uint32)

    t = [out_triplet(j) for j in range(9)]
    e_val = (
        t[0] | (t[1] << 7) | (t[2] << 14) | (t[3] << 21)
        | ((t[4] & jnp.uint32(0xF)) << 28)
    )
    o_val = (
        (t[4] >> 4) | (t[5] << 3) | (t[6] << 10) | (t[7] << 17) | (t[8] << 24)
    )
    # lane pair (2w, 2w+1) computed output word W-1-w; after the lane
    # reversal the even lane must land the lo half, so pre-reverse the even
    # lane carries the ODD half and vice versa
    out = jnp.where(even, o_val, e_val)[::-1]
    if W < W_cap:
        out = jnp.concatenate(
            [out, jnp.zeros(2 * (W_cap - W), jnp.uint32)]
        )
    return out


def first_invalid_word_b5(words: jax.Array) -> jax.Array:
    """Stream-integrity check: index of the first corrupt u64 word of a
    base-5 stream (any triplet value >= 125, or pad bit 63 set), else -1.

    The 2-bit stream has no invalid states (every bit pattern decodes), but
    base-5 words waste 3 of 128 triplet codes and 1 bit — a cheap
    whole-stream scan catches container corruption before decode
    (u32[..., 2W] -> i32[...]).
    """
    if words.shape[-1] % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    if words.shape[-1] == 0:
        return jnp.full(words.shape[:-1], -1, jnp.int32)
    bad = _b5_lane_parity_reduce(
        words,
        lambda t: t >= 125,
        combine=lambda a, v: a | v,
        init=lambda shape: jnp.zeros(shape, bool),
    )
    # the pad bit (63) lives in the hi half: flag odd lanes with bit 31 set
    lane = jax.lax.broadcasted_iota(jnp.int32, words.shape, words.ndim - 1)
    bad = bad | (((lane & 1) == 1) & ((words >> 31) != 0))
    idx = jnp.argmax(bad, axis=-1) >> 1  # lane index -> u64 word index
    return jnp.where(jnp.any(bad, axis=-1), idx, -1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Region extraction / concatenation on the packed domain
# ---------------------------------------------------------------------------
# samtools-faidx-style subsequence access without a decode round-trip: a
# funnel shift over the packed words (2-bit) or over the 7-bit triplet
# domain (base-5).  Offsets are STATIC (each distinct (start, n) compiles
# its own funnel); out-of-range positions read as 'A' (digit 0), which is
# the padding convention everywhere else in this package, and negative
# ``start`` is allowed — it places the stream at offset ``-start`` inside
# the window, which is exactly what concatenation needs.


@functools.partial(jax.jit, static_argnames=("start", "n"))
def packed_slice(words: jax.Array, start: int, n: int) -> jax.Array:
    """Extract nucleotides ``[start, start + n)`` of a 2-bit packed stream.

    u32[W] -> u32[ceil(n/16)] with zeroed tail bits — bit-exact to
    re-encoding ``decode(words)[start:start+n]`` — in one fused funnel pass
    (both taps read the input *parameter*, so XLA does not materialize an
    intermediate; see :func:`revcomp_packed` on why that matters).
    """
    if words.ndim != 1:
        raise TypeError("packed_slice takes a flat u32 word stream")
    if n < 0:
        raise ValueError("n must be >= 0")
    if n == 0:
        return jnp.zeros(0, jnp.uint32)
    W = words.shape[0]
    w_used = -(-n // spec.NT_PER_U32_2BIT)   # u32 lanes carrying data
    w_out = 2 * (-(-n // 32))                # u64-pair container size
    lane_sh, half = divmod(start, spec.NT_PER_U32_2BIT)
    bit_sh = 2 * half
    need = 1 if bit_sh else 0
    pad_front = max(0, -lane_sh)
    pad_back = max(0, lane_sh + w_used + need - W)
    xp = words
    if pad_front or pad_back:
        xp = jnp.concatenate(
            [
                jnp.zeros(pad_front, jnp.uint32),
                words,
                jnp.zeros(pad_back, jnp.uint32),
            ]
        )
    base = lane_sh + pad_front
    cur = jax.lax.slice(xp, (base,), (base + w_used,))
    if bit_sh:
        nxt = jax.lax.slice(xp, (base + 1,), (base + 1 + w_used,))
        cur = (cur >> bit_sh) | (nxt << (32 - bit_sh))
    r = n % spec.NT_PER_U32_2BIT
    if r:
        cur = cur.at[-1].set(cur[-1] & jnp.uint32((1 << (2 * r)) - 1))
    if w_out > w_used:  # the hi u32 of a half-filled final u64 word
        cur = jnp.concatenate([cur, jnp.zeros(w_out - w_used, jnp.uint32)])
    return cur


@functools.partial(jax.jit, static_argnames=("len_a", "len_b"))
def packed_concat(
    a: jax.Array, len_a: int, b: jax.Array, len_b: int
) -> jax.Array:
    """Concatenate two 2-bit packed streams at the nucleotide level.

    (u32[Wa], len_a, u32[Wb], len_b) -> u32[ceil((len_a+len_b)/16)], the
    packed stream of sequence ``a ++ b``.  ``b``'s bits land at arbitrary
    (non-word-aligned) offsets via :func:`packed_slice`'s negative-start
    window; ``a``'s tail is re-masked, so dirty bits beyond either length
    cannot leak.
    """
    w_out = 2 * (-(-(len_a + len_b) // 32))
    if w_out == 0:
        return jnp.zeros(0, jnp.uint32)
    sb = packed_slice(b, -len_a, len_a + len_b)
    if len_a == 0:
        return sb
    wa = packed_slice(a, 0, len_a)
    if wa.shape[0] < w_out:
        wa = jnp.concatenate(
            [wa, jnp.zeros(w_out - wa.shape[0], jnp.uint32)]
        )
    return wa | sb


@functools.partial(jax.jit, static_argnames=("start", "n"))
def packed_slice_b5(words: jax.Array, start: int, n: int) -> jax.Array:
    """Extract nucleotides ``[start, start + n)`` of a base-5 packed stream.

    Interleaved u32[2W] -> u32[2*ceil(n/27)] with zero tail digits and pad
    bits — bit-exact to re-encoding the decoded window.  The funnel runs on
    the 7-bit triplet domain (digit shifts are exact multiply-shift /5, /25;
    reference src/n_to_bits2.rs:241-247): output triplet ``T`` reads input
    triplets ``start//3 + T`` and ``+1``, every tap a lane-shifted read of
    the raw input parameter (the :func:`revcomp_packed_b5` structure without
    the reversal) — one memory pass, no decode round-trip.
    """
    if words.ndim != 1 or words.shape[0] % 2:
        raise TypeError("packed_slice_b5 takes a flat interleaved u32[2W] stream")
    if n < 0:
        raise ValueError("n must be >= 0")
    if n == 0:
        return jnp.zeros(0, jnp.uint32)
    W = words.shape[0] // 2
    w_out = -(-n // spec.NT_PER_WORD_B5)
    q0, r0 = divmod(start, 3)
    x = words

    def tap(off: int) -> jax.Array:
        """Output-lane view: out lane ``k`` reads ``words[k + off]``
        (zero outside the stream)."""
        k0 = min(max(0, -off), 2 * w_out)          # first in-range out lane
        k1 = max(k0, min(2 * w_out, 2 * W - off))  # one past the last
        if k1 <= k0:  # whole window outside the stream
            return jnp.zeros(2 * w_out, jnp.uint32)
        seg = jax.lax.slice(x, (k0 + off,), (k1 + off,))
        if k0 or 2 * w_out - k1:
            seg = jnp.concatenate(
                [
                    jnp.zeros(k0, jnp.uint32),
                    seg,
                    jnp.zeros(2 * w_out - k1, jnp.uint32),
                ]
            )
        return seg

    lane = jax.lax.iota(jnp.int32, 2 * w_out)
    even = (lane & 1) == 0
    w_idx = lane >> 1
    e = q0 // 9  # word offsets used are e and e+1 only
    lo_of = {
        o: jnp.where(even, tap(2 * o), tap(2 * o - 1)) for o in (e, e + 1)
    }
    hi_of = {
        o: jnp.where(even, tap(2 * o + 1), tap(2 * o)) for o in (e, e + 1)
    }

    def src_triplet(g: int) -> jax.Array:
        """Input triplet ``9w + g`` (relative to out word w) as i32."""
        o, jj = divmod(g, 9)
        return _b5_word_triplet(lo_of[o], hi_of[o], jj).astype(jnp.int32)

    big_m = (n - 1) // 3          # last output triplet
    u = n - 3 * big_m             # digits used in it (1..3)

    def out_triplet(j: int) -> jax.Array:
        t1 = src_triplet(q0 + j)
        if r0 == 0:
            val = t1
        else:
            t2 = src_triplet(q0 + j + 1)
            if r0 == 1:
                val = ((t1 * 205) >> 10) + 25 * (t2 - 5 * ((t2 * 205) >> 10))
            else:  # r0 == 2
                val = ((t1 * 41) >> 10) + 5 * (t2 - 25 * ((t2 * 41) >> 10))
        if u < 3 and j == big_m % 9:
            # the boundary triplet keeps only its low ``u`` digits
            c = 205 if u == 1 else 41
            part = val - (5**u) * ((val * c) >> 10)
            val = jnp.where(w_idx == big_m // 9, part, val)
        # whole triplets past the window are zero
        return jnp.where(
            27 * w_idx + 3 * j < n, val, 0
        ).astype(jnp.uint32)

    t = [out_triplet(j) for j in range(9)]
    e_val = (
        t[0] | (t[1] << 7) | (t[2] << 14) | (t[3] << 21)
        | ((t[4] & jnp.uint32(0xF)) << 28)
    )
    o_val = (
        (t[4] >> 4) | (t[5] << 3) | (t[6] << 10) | (t[7] << 17) | (t[8] << 24)
    )
    return jnp.where(even, e_val, o_val)


@functools.partial(jax.jit, static_argnames=("len_a", "len_b"))
def packed_concat_b5(
    a: jax.Array, len_a: int, b: jax.Array, len_b: int
) -> jax.Array:
    """Concatenate two base-5 packed streams at the nucleotide level.

    (u32[2Wa], len_a, u32[2Wb], len_b) -> u32[2*ceil((len_a+len_b)/27)].
    The streams are joined in the DIGIT domain: ``a`` re-masked to its
    length, ``b`` digit-shifted to offset ``len_a`` (a negative-start
    :func:`packed_slice_b5`), then summed — the triplet straddling the
    boundary combines ``a``'s low digits with ``b``'s high digits by
    addition (each 7-bit chunk sums to < 125, so no carry leaves a chunk;
    the one chunk spanning a u32 pair boundary gets its carry propagated
    lane-to-lane explicitly, an emulated u64 add).
    """
    w_out = -(-(len_a + len_b) // spec.NT_PER_WORD_B5)
    if w_out == 0:
        return jnp.zeros(0, jnp.uint32)
    sb = packed_slice_b5(b, -len_a, len_a + len_b)
    if len_a == 0:
        return sb
    wa = packed_slice_b5(a, 0, len_a)
    wa = jnp.concatenate(
        [wa, jnp.zeros(2 * w_out - wa.shape[0], jnp.uint32)]
    )
    s = wa + sb
    # triplet 4 of the boundary word spans its u32 pair (lo bits 28-31 +
    # hi bits 0-2); a digit-sum carry out of bit 31 must land in the hi
    # lane: detect unsigned overflow on even lanes, bump the next lane
    carry = ((s < wa) & ((jax.lax.iota(jnp.int32, 2 * w_out) & 1) == 0))
    s = s + jnp.concatenate(
        [jnp.zeros(1, jnp.uint32), carry.astype(jnp.uint32)[:-1]]
    )
    return s


# ---------------------------------------------------------------------------
# Codon translation on the packed domain
# ---------------------------------------------------------------------------
# DNA -> protein without decoding: a codon is the 6-bit window starting at
# every third position of the 2-bit stream — exactly the k = 3 funnel of
# :mod:`.kmer` — and the standard genetic code is one 64-entry LUT on that
# code (first base in the LOW 2 bits, the stream's LSB-first convention).


@functools.lru_cache(maxsize=1)
def _codon_lut() -> "np.ndarray":
    """64-entry codon -> amino-acid LUT indexed by ``c0 + 4 c1 + 16 c2``
    (2-bit codes A=0 C=1 T=2 G=3).  NCBI standard code (table 1), built
    from the canonical TCAG-order spelling so no codon is hand-transcribed;
    stops are ``*``."""
    import numpy as np

    aas = b"FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
    code = {ord("A"): 0, ord("C"): 1, ord("T"): 2, ord("G"): 3}
    tcag = b"TCAG"
    lut = np.zeros(64, np.uint8)
    for i, aa in enumerate(aas):
        b1, b2, b3 = tcag[i >> 4], tcag[(i >> 2) & 3], tcag[i & 3]
        lut[code[b1] | (code[b2] << 2) | (code[b3] << 4)] = aa
    return lut


@functools.partial(jax.jit, static_argnames=("length", "frame"))
def translate_packed(
    words: jax.Array, length: int, frame: int = 0
) -> jax.Array:
    """Translate a 2-bit packed stream to amino acids: -> u8[(length-frame)//3].

    ``frame`` in {0, 1, 2} is the forward reading-frame offset.  Codons are
    read straight off the packed words (the k = 3 funnel window of
    :func:`.kmer.kmer_codes` at stride 3) and mapped through the standard
    genetic code; stop codons emit ``*``.  For reverse frames feed
    :func:`revcomp_packed` output (:func:`translate_6frame` does).
    """
    from . import kmer

    if frame not in (0, 1, 2):
        raise ValueError("frame must be 0, 1 or 2")
    n_cod = (length - frame) // 3
    if n_cod <= 0:
        raise ValueError(f"length {length} has no frame-{frame} codon")
    codes = kmer.kmer_codes(words, length, 3)
    sel = jax.lax.slice(codes, (frame,), (frame + 3 * (n_cod - 1) + 1,), (3,))
    return jnp.take(jnp.asarray(_codon_lut()), sel).astype(jnp.uint8)


def translate_6frame(words: jax.Array, length: int) -> list[jax.Array]:
    """All six reading frames: ``[+0, +1, +2, -0, -1, -2]`` as u8 arrays.

    Reverse frames translate the reverse complement (computed on the packed
    domain by :func:`revcomp_packed` — still no decode pass); frame ``-j``
    starts ``j`` nucleotides into the reverse-complemented sequence, the
    samtools/EMBOSS convention.
    """
    rc = revcomp_packed(words, length)
    return [translate_packed(words, length, f) for f in range(3)] + [
        translate_packed(rc, length, f) for f in range(3)
    ]


@functools.lru_cache(maxsize=1)
def _codon_lut_b5() -> "np.ndarray":
    """125-entry codon LUT on the base-5 TRIPLET value ``a + 5b + 25c``.

    The packed triplet IS the codon: base-5 digits 0-3 equal the 2-bit
    codes (A C T G in the same order), so non-N entries reuse
    :func:`_codon_lut`; any codon containing N (digit 4) translates to
    ``X`` (the IUPAC unknown amino acid).  Padded to 128 entries so take()
    stays in range for the (unreachable in valid streams) values 125-127.
    """
    import numpy as np

    lut64 = _codon_lut()
    lut = np.full(128, ord("X"), np.uint8)
    for t in range(125):
        a, b, c = t % 5, (t // 5) % 5, t // 25
        if a < 4 and b < 4 and c < 4:
            lut[t] = lut64[a | (b << 2) | (c << 4)]
    return lut


@functools.partial(jax.jit, static_argnames=("length", "frame"))
def translate_packed_b5(
    words: jax.Array, length: int, frame: int = 0
) -> jax.Array:
    """Translate a base-5 packed u32[2W] stream: -> u8[(length-frame)//3].

    No decode pass and — unlike the 2-bit path — not even a funnel: a
    frame-0 codon occupies exactly one packed TRIPLET, so translation is a
    per-triplet 125-entry LUT; frames 1/2 first shift the digit stream
    with :func:`packed_slice_b5` (digit-domain, one fused pass).  Codons
    containing N emit ``X``; stops emit ``*``.
    """
    if words.ndim != 1 or words.shape[0] % 2:
        raise TypeError("translate_packed_b5 takes a flat interleaved u32[2W]")
    if frame not in (0, 1, 2):
        raise ValueError("frame must be 0, 1 or 2")
    if length > (words.shape[0] // 2) * spec.NT_PER_WORD_B5:
        raise ValueError(f"length {length} exceeds capacity")
    n_cod = (length - frame) // 3
    if n_cod <= 0:
        raise ValueError(f"length {length} has no frame-{frame} codon")
    w = packed_slice_b5(words, frame, length - frame) if frame else words
    lo, hi = w[0::2], w[1::2]
    trips = jnp.stack(
        [_b5_word_triplet(lo, hi, j).astype(jnp.int32) for j in range(9)],
        axis=1,
    )
    codes = trips.reshape(-1)[:n_cod]
    return jnp.take(jnp.asarray(_codon_lut_b5()), codes).astype(jnp.uint8)


def translate_6frame_b5(words: jax.Array, length: int) -> list[jax.Array]:
    """All six frames of a base-5 stream (N-aware), packed-domain reverse
    complement for the minus strand — the base-5 mirror of
    :func:`translate_6frame`."""
    rc = revcomp_packed_b5(words, length)
    return [translate_packed_b5(words, length, f) for f in range(3)] + [
        translate_packed_b5(rc, length, f) for f in range(3)
    ]


# --- exact read deduplication -----------------------------------------------

@jax.jit
def duplicate_mask(words: jax.Array, lengths: jax.Array) -> jax.Array:
    """True for rows duplicating an EARLIER row: (u32[B, W], i32[B]) -> bool[B].

    ``seqkit rmdup -s``'s job on the packed domain: two reads are
    duplicates iff their normalized sequences are identical (same length,
    same packed words — the codec's case/U folding and 'A' padding make
    content equality plain word equality).  One stable multi-key
    ``lax.sort`` over (length, every word column) makes equal rows
    adjacent in first-occurrence order; a neighbor compare marks all but
    the group head.  Exact — the sort keys ARE the full content, no hash
    involved.  W is static, so the comparator has W + 1 keys; intended
    for read batches (W up to a few hundred words).
    """
    B, W = words.shape
    idx = jnp.arange(B, dtype=jnp.int32)
    keys = (lengths.astype(jnp.int32),) + tuple(
        words[:, w] for w in range(W)
    )
    out = jax.lax.sort(
        keys + (idx,), num_keys=len(keys), is_stable=True
    )
    s_len, s_words, s_idx = out[0], out[1:-1], out[-1]
    same = s_len[1:] == s_len[:-1]
    for col in s_words:
        same = same & (col[1:] == col[:-1])
    dup_sorted = jnp.concatenate([jnp.zeros((1,), bool), same])
    # scatter back: row s_idx[i] is a duplicate iff dup_sorted[i]
    return jnp.zeros((B,), bool).at[s_idx].set(dup_sorted)
