"""Batch codec "models": the device-array production API.

The reference's public surface is 12 free functions over host byte slices
(reference src/lib.rs:1-2).  The production path here instead operates on
resident device arrays of shape ``[batch, length]`` — a batch of reads —
because on an accelerator the unit of efficiency is a large batched launch,
not a single string.  These classes bundle the jitted kernels, padding
logic, variant registry, and sharding hooks into the two codec families:

* :class:`TwoBitCodec` — {A,C,G,T/U} <-> 2 bits/nt  (reference src/n_to_bits.rs)
* :class:`Base5Codec`  — {A,C,G,T/U,N} <-> 63 bits/27 nt (reference src/n_to_bits2.rs)

Both produce packed ``uint32`` device words whose little-endian stream is
bit-exact to the reference's ``Vec<u64>`` output.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import spec, xla

__all__ = ["CodecConfig", "TwoBitCodec", "Base5Codec", "pad_batch"]


#: backends the XLA tier is known to compile for
_XLA_PLATFORMS = ("cpu", "gpu", "cuda", "rocm")


def _default_tier() -> str:
    """The device tier "auto" resolves to on the default backend.

    Raises on a platform the codec has not been built for, instead of
    guessing a tier that may not lower there.
    """
    platform = jax.default_backend()
    if platform not in _XLA_PLATFORMS:
        raise RuntimeError(
            f"no codec tier for backend {platform!r}; known: {_XLA_PLATFORMS}"
        )
    return "xla"


#: fastest variant per tier.  On an H100 (device time, 256 MiB batch) the
#: three SWAR encoders tie at ~0.108 ms and "dot" takes 2.1x that; decode
#: "swar"/"shuffle" tie at ~0.114 ms, "select" 1.3x, "broadcast" 2.8x —
#: see PERF.md.  ``None`` variant arguments resolve through these (the
#: reference likewise names a per-situation best, reference
#: README.md:355-356).
DEFAULT_ENCODE_VARIANT = {"xla": "mul", "oracle": "lut"}
DEFAULT_DECODE_VARIANT = {"xla": "swar", "oracle": "lut"}


def default_encode_variant(tier: str) -> str:
    """The fastest 2-bit encode variant for a (resolved) tier."""
    if tier == "auto":
        tier = _default_tier()
    return DEFAULT_ENCODE_VARIANT[tier]


def default_decode_variant(tier: str) -> str:
    """The fastest 2-bit decode variant for a (resolved) tier."""
    if tier == "auto":
        tier = _default_tier()
    return DEFAULT_DECODE_VARIANT[tier]


@functools.lru_cache(maxsize=None)
def _jit_decode_b5_checked():
    from ..ops import seqops

    return jax.jit(
        lambda w: (
            xla.decode_b5_bytes(w),
            jnp.any(seqops.first_invalid_word_b5(w) >= 0),
        )
    )


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Typed configuration (the config system the reference lacks; SURVEY §5).

    Attributes:
      tier: "xla" (whole-array fused kernels) or "auto" (the default
        backend's tier; raises on a backend the codec does not know).
      encode_variant: packing strategy for the 2-bit encoder —
        "mul" (multiply-as-bit-shuffle, analogue of reference
        src/n_to_bits.rs:213), "shift" (log-depth shift-OR tree,
        src/n_to_bits.rs:121), "interleave" (even/odd plane split + fold,
        the movemask analogue, src/n_to_bits.rs:172) or "dot"
        (bitcast-free power-of-4-weighted sum, the pext slot,
        src/n_to_bits.rs:80).  ``None`` (the default) resolves to the
        fastest, "mul".
      decode_variant: "swar" (byte-parallel spread-multiplies, the pdep
        descendant, reference src/n_to_bits.rs:309), "shuffle"
        (packed-LUT variable shift, src/n_to_bits.rs:265), "select"
        (arithmetic select tree, the clmul slot, src/n_to_bits.rs:346) or
        "broadcast" (bitcast-free field broadcast).  ``None`` resolves to
        the fastest, "swar".
      donate: donate input buffers to the compiled call (the allocation-honest
        analogue of the reference's alloc-included benchmarks).
    """

    tier: str = "auto"
    encode_variant: str | None = None
    decode_variant: str | None = None
    donate: bool = False

    def resolved_tier(self) -> str:
        return _default_tier() if self.tier == "auto" else self.tier

    def resolved_encode_variant(self) -> str:
        if self.encode_variant is not None:
            return self.encode_variant
        return DEFAULT_ENCODE_VARIANT[self.resolved_tier()]

    def resolved_decode_variant(self) -> str:
        if self.decode_variant is not None:
            return self.decode_variant
        return DEFAULT_DECODE_VARIANT[self.resolved_tier()]


def pad_batch(
    reads: np.ndarray | list[bytes], block: int, fill: int = ord("A")
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a batch of byte strings to a common block-aligned length.

    Returns ``(batch u8[B, Lpad], lengths i32[B])``.  Padding with 'A'
    (code 0 / digit 0) reproduces the reference's tail semantics: unused high
    bits zero (reference src/n_to_bits.rs:38-43), missing triplet digits zero
    (reference src/n_to_bits2.rs:58-70).
    """
    if isinstance(reads, np.ndarray):
        if reads.ndim != 2 or reads.dtype != np.uint8:
            raise TypeError("expected u8[B, L] array or list of bytes")
        lengths = np.full(reads.shape[0], reads.shape[1], dtype=np.int32)
        rem = (-reads.shape[1]) % block
        if rem:
            pad = np.full((reads.shape[0], rem), fill, dtype=np.uint8)
            reads = np.concatenate([reads, pad], axis=1)
        return reads, lengths
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    lpad = spec.cdiv(max((int(l) for l in lengths), default=0), block) * block
    out = np.full((len(reads), max(lpad, block)), fill, dtype=np.uint8)
    for i, r in enumerate(reads):
        out[i, : len(r)] = np.frombuffer(bytes(r), dtype=np.uint8)
    return out, lengths


class _CodecBase:
    """Shared jit/caching scaffolding for the two codec families."""

    def __init__(self, config: CodecConfig | None = None, **overrides):
        if config is None:
            config = CodecConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        if config.tier not in ("xla", "auto"):
            raise ValueError(
                f"unknown codec tier {config.tier!r}; expected 'xla' or 'auto'"
            )
        self.config = config
        self.tier = config.resolved_tier()

    def _jit(self, fn, donate_arg: bool):
        kwargs = {}
        if donate_arg and self.config.donate:
            kwargs["donate_argnums"] = (0,)
        return jax.jit(fn, **kwargs)


class TwoBitCodec(_CodecBase):
    """Batched 2-bit codec: u8[..., L] <-> packed u32[..., L//16].

    Bit-exact to the reference's 2-bit family (encoders
    src/n_to_bits.rs:34-259, decoders :265-404); tested against its golden
    vectors (src/n_to_bits.rs:408-470).
    """

    #: nt per packed u32 word
    block = spec.NT_PER_WORD_2BIT  # pad granularity: one logical u64 (32 nt)

    def __init__(self, config: CodecConfig | None = None, **overrides):
        super().__init__(config, **overrides)
        self.encode_variant = self.config.resolved_encode_variant()
        self.decode_variant = self.config.resolved_decode_variant()
        if self.encode_variant not in xla.ENCODE_2BIT_VARIANTS:
            raise ValueError(
                f"unknown encode_variant {self.encode_variant!r}; expected "
                f"one of {xla.ENCODE_2BIT_VARIANTS}"
            )
        if self.decode_variant not in xla.DECODE_2BIT_VARIANTS:
            raise ValueError(
                f"unknown decode_variant {self.decode_variant!r}; expected "
                f"one of {xla.DECODE_2BIT_VARIANTS}"
            )
        self._encode = self._jit(
            functools.partial(xla.encode_2bit_words, variant=self.encode_variant),
            donate_arg=True,
        )
        self._decode = self._jit(
            functools.partial(xla.decode_2bit_bytes, variant=self.decode_variant),
            donate_arg=True,
        )
        # no donation: the caller may still hold the reads it validates
        self._encode_checked = jax.jit(
            functools.partial(
                xla.encode_2bit_words_checked, variant=self.encode_variant
            )
        )

    def encode(self, reads: jax.Array) -> jax.Array:
        """u8[..., L] -> u32[..., L//16]; L must be a multiple of 16."""
        return self._encode(reads)

    def encode_checked(self, reads: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Encode + per-row validity flag: u8[..., L] ->
        (u32[..., L//16], bool[...]).

        Flag row r is True iff it contains a byte outside {A,C,G,T,U}
        (either case); encode and check run in one compiled program.
        Diagnose flagged rows with :func:`..ops.validate.first_invalid`.
        """
        return self._encode_checked(reads)

    def decode(self, words: jax.Array) -> jax.Array:
        """u32[..., W] -> u8[..., 16*W] (full blocks; caller truncates)."""
        return self._decode(words)

    def words_per_read(self, length: int) -> int:
        return 2 * spec.num_words_2bit(length)  # u32 count

    def pad(self, reads):
        return pad_batch(reads, self.block)


class Base5Codec(_CodecBase):
    """Batched base-5 codec: u8[..., L] <-> packed u32[..., 2*(L//27)].

    Bit-exact to the reference's base-5 family (src/n_to_bits2.rs:37-268);
    tested against its golden vectors (src/n_to_bits2.rs:270-299).
    """

    #: nt per logical u64 word
    block = spec.NT_PER_WORD_B5

    def __init__(self, config: CodecConfig | None = None, **overrides):
        super().__init__(config, **overrides)
        self._encode = self._jit(xla.encode_b5_words, donate_arg=True)
        self._decode = self._jit(xla.decode_b5_bytes, donate_arg=True)
        self._encode_checked = jax.jit(xla.encode_b5_words_checked)

    def encode(self, reads: jax.Array) -> jax.Array:
        """u8[..., L] -> u32[..., 2*(L//27)]; L must be a multiple of 27."""
        return self._encode(reads)

    def encode_checked(self, reads: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Encode + validity flag: u8[..., L] -> (u32[..., 2*(L//27)],
        bool scalar).

        The flag is True iff ANY byte is outside {A,C,G,T,U,N} (either
        case); encode and check run in one compiled program.  Diagnose with
        :func:`..ops.validate.first_invalid`.
        """
        return self._encode_checked(reads)

    def decode(self, words: jax.Array) -> jax.Array:
        """u32[..., 2*W] -> u8[..., 27*W] (full blocks; caller truncates)."""
        return self._decode(words)

    def decode_checked(self, words: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Decode + stream-integrity flag: u32[..., 2*W] ->
        (u8[..., 27*W], bool scalar).

        The flag is True iff ANY u64 word of the stream is corrupt (a
        triplet value >= 125 or pad bit 63 set — base-5 words waste 3 of
        128 triplet codes, so container corruption is detectable; the
        2-bit stream has no invalid states).  Decode and check run in one
        compiled program; use :func:`..ops.seqops.first_invalid_word_b5`
        to diagnose the word index on flagged batches.
        """
        return _jit_decode_b5_checked()(words)

    def words_per_read(self, length: int) -> int:
        return 2 * spec.num_words_b5(length)

    def pad(self, reads):
        return pad_batch(reads, self.block)
