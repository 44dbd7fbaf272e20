"""Data-parallel batch codec over a device mesh.

Reads are independent, so data parallelism is pure sharding: the batch axis is
split over the ``"data"`` mesh axis, each device encodes its shard with the
single-device kernel, and no collective is needed unless the caller asks for a
replicated (gathered) result.  This promotes the reference's only
parallelism — SIMD lanes inside one AVX2 register (SURVEY.md §2.3) — to a
device-mesh axis.

Two entry styles:

* :func:`data_parallel_encode` / :func:`data_parallel_decode` — functional,
  explicit `shard_map` over a mesh; optionally `all_gather`s packed words so
  every device holds the full result (the merge step of BASELINE's multi-host
  configs).
* :class:`ShardedCodec` — object API wrapping a codec model with a mesh and
  input/output shardings, for streaming pipelines.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models import _default_tier, default_decode_variant, default_encode_variant
from ..ops import xla
from ..ops.search import _norm_lengths
from . import mesh as mesh_lib


def _check_tier(tier: str) -> None:
    """Reject tiers the device path does not have ("auto" must resolve)."""
    if tier == "auto":
        tier = _default_tier()
    if tier != "xla":
        raise ValueError(f"unknown device tier {tier!r}; expected 'xla' or 'auto'")


def _encode_fn(codec: str, variant: str, tier: str):
    _check_tier(tier)
    if codec == "2bit":
        return functools.partial(xla.encode_2bit_words, variant=variant)
    return xla.encode_b5_words


def _decode_fn(codec: str, variant: str, tier: str):
    _check_tier(tier)
    if codec == "2bit":
        return functools.partial(xla.decode_2bit_bytes, variant=variant)
    return xla.decode_b5_bytes


@functools.lru_cache(maxsize=None)
def _jit_dp(codec: str, variant: str, tier: str, mesh: Mesh, gather: bool, decode: bool):
    axis = mesh_lib.DATA_AXIS
    fn = (_decode_fn if decode else _encode_fn)(codec, variant, tier)

    def per_shard(x):
        out = fn(x)
        if gather:
            out = jax.lax.all_gather(out, axis, axis=0, tiled=True)
        return out

    out_spec = P(None if gather else axis, None)
    mapped = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis, None),),
        out_specs=out_spec,
        check_vma=False,
    )
    return jax.jit(mapped)


def data_parallel_encode(
    reads: jax.Array,
    *,
    mesh: Mesh | None = None,
    codec: str = "2bit",
    variant: str | None = None,
    tier: str = "auto",
    gather: bool = False,
) -> jax.Array:
    """Encode u8[B, L] with B sharded over the mesh's data axis.

    ``gather=True`` all-gathers packed words over the mesh so the result is
    replicated (otherwise it stays sharded, the right form for a streaming
    sink).  B must divide by the data-axis size; L by 16 (2bit) / 27 (base5).
    ``variant=None`` resolves to the tier's fastest form.
    """
    if mesh is None:
        mesh = mesh_lib.default_mesh()
    if variant is None:
        variant = default_encode_variant(tier)
    return _jit_dp(codec, variant, tier, mesh, gather, False)(reads)


def data_parallel_decode(
    words: jax.Array,
    *,
    mesh: Mesh | None = None,
    codec: str = "2bit",
    variant: str | None = None,
    tier: str = "auto",
    gather: bool = False,
) -> jax.Array:
    """Decode packed u32[B, W] with B sharded over the mesh's data axis."""
    if mesh is None:
        mesh = mesh_lib.default_mesh()
    if variant is None:
        variant = default_decode_variant(tier)
    return _jit_dp(codec, variant, tier, mesh, gather, True)(words)


@functools.lru_cache(maxsize=None)
def _jit_dp_encode_checked(
    codec: str, variant: str, tier: str, mesh: Mesh, gather: bool
):
    from ..ops import validate

    axis = mesh_lib.DATA_AXIS
    encode = _encode_fn(codec, variant, tier)

    def per_shard(reads):
        words = encode(reads)
        bad = jnp.any(~validate.valid_mask(reads, allow_n=codec == "base5"))
        if gather:
            words = jax.lax.all_gather(words, axis, axis=0, tiled=True)
        return words, jax.lax.psum(bad.astype(jnp.int32), axis)

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None),),
            out_specs=(P(None if gather else axis, None), P()),
            check_vma=False,
        )
    )


def data_parallel_encode_checked(
    reads: jax.Array,
    *,
    mesh: Mesh | None = None,
    codec: str = "2bit",
    variant: str | None = None,
    tier: str = "auto",
    gather: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Encode + fused input-validity flag over the data axis:
    u8[B, L] -> (packed words sharded, replicated i32 flagged-shard count).

    The per-shard check (:func:`..ops.validate.valid_mask`) compiles into
    the same program as the encode; one ``psum`` merges the flags (0 iff every byte on every device is in
    the codec's alphabet, either case).
    """
    if mesh is None:
        mesh = mesh_lib.default_mesh()
    if variant is None:
        variant = default_encode_variant(tier)
    return _jit_dp_encode_checked(codec, variant, tier, mesh, gather)(reads)


@functools.lru_cache(maxsize=None)
def _jit_dp_decode_checked(tier: str, mesh: Mesh):
    from ..ops import seqops

    axis = mesh_lib.DATA_AXIS
    _check_tier(tier)

    def per_shard(words):
        dec = xla.decode_b5_bytes(words)
        bad = jnp.any(seqops.first_invalid_word_b5(words) >= 0)
        # psum'd count of flagged shards: 0 iff every device's slice is clean
        return dec, jax.lax.psum(bad.astype(jnp.int32), axis)

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None),),
            out_specs=(P(axis, None), P()),
            check_vma=False,
        )
    )


def data_parallel_decode_checked(
    words: jax.Array,
    *,
    mesh: Mesh | None = None,
    tier: str = "auto",
) -> tuple[jax.Array, jax.Array]:
    """Base-5 decode + fused stream-integrity flag over the data axis:
    u32[B, 2W] -> (u8[B, 27W] sharded, replicated i32 flagged-shard count).

    The per-shard check (:func:`..ops.seqops.first_invalid_word_b5`)
    compiles into the same program as the decode; one ``psum`` merges the
    flags.
    Base-5 only — every 2-bit pattern decodes, there is nothing to check.
    """
    if mesh is None:
        mesh = mesh_lib.default_mesh()
    return _jit_dp_decode_checked(tier, mesh)(words)


@functools.lru_cache(maxsize=None)
def _jit_spectrum(k: int, canonical: bool, mesh: Mesh):
    from ..ops import kmer as kmer_lib

    axis = mesh_lib.DATA_AXIS

    def per_shard(words, lengths):
        h = kmer_lib.kmer_histogram_batch(words, lengths, k, canonical=canonical)
        return jax.lax.psum(h, axis)

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis)),
            out_specs=P(None),
            check_vma=False,
        )
    )


def kmer_spectrum(
    words: jax.Array,
    lengths,
    k: int,
    *,
    mesh: Mesh | None = None,
    canonical: bool = False,
) -> jax.Array:
    """Global k-mer spectrum of a packed read batch over the mesh:
    u32[B, W] + lengths -> replicated i32[4**k].

    The distributed analysis pipeline in one collective: the batch axis
    shards over the data axis, each device runs the planar-extraction +
    histogram pass on its shard (:func:`..ops.kmer.kmer_histogram_batch` —
    windows never span reads, padding masked via ``lengths``), and one
    ``psum`` merges the 4**k-bin spectra.  B must divide by the
    data-axis size; k <= 12 (dense bins).
    """
    if mesh is None:
        mesh = mesh_lib.default_mesh()
    lengths = _norm_lengths(lengths, words.shape[0])
    return _jit_spectrum(k, canonical, mesh)(words, lengths)


@functools.lru_cache(maxsize=None)
def _jit_match_counts(query: bytes, codec: str, mesh: Mesh):
    from ..ops import search as search_lib

    axis = mesh_lib.DATA_AXIS

    def per_shard(words, lengths):
        c = search_lib.match_counts_batch(words, lengths, query, codec=codec)
        return jax.lax.all_gather(c, axis, axis=0, tiled=True)

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis)),
            out_specs=P(None),
            check_vma=False,
        )
    )


def match_counts(
    words: jax.Array,
    lengths,
    query: bytes,
    *,
    mesh: Mesh | None = None,
    codec: str = "2bit",
) -> jax.Array:
    """Distributed grep over a packed read batch: per-read occurrence
    counts of ``query``, batch sharded over the data axis, all-gathered to
    a replicated i32[B].  ``codec="base5"`` scans interleaved base-5 rows
    (``N`` literal, ``?`` wildcard); B must divide by the data-axis size."""
    if mesh is None:
        mesh = mesh_lib.default_mesh()
    if isinstance(query, str):
        query = query.encode()
    lengths = _norm_lengths(lengths, words.shape[0])
    return _jit_match_counts(bytes(query), codec, mesh)(words, lengths)


@functools.lru_cache(maxsize=None)
def _jit_sketch(k: int, s: int, canonical: bool, mesh: Mesh):
    from ..ops import sketch as sketch_lib

    axis = mesh_lib.DATA_AXIS

    def per_shard(words, lengths):
        sk = sketch_lib.bottom_k_sketch_batch(
            words, lengths, k, s, canonical=canonical
        )
        # per-shard sketches are tiny (s u32); one gather + one distinct
        # pass IS the associative union-merge of every shard's sketch
        all_sk = jax.lax.all_gather(sk, axis, axis=0)
        return sketch_lib.merge_many(all_sk)

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis)),
            out_specs=P(None),
            check_vma=False,
        )
    )


def sketch_sharded(
    words: jax.Array,
    lengths,
    k: int,
    s: int,
    *,
    mesh: Mesh | None = None,
    canonical: bool = True,
) -> jax.Array:
    """Cluster-wide bottom-``s`` MinHash sketch of a packed read batch:
    u32[B, W] + lengths -> replicated sorted u32[s].

    Each device sketches its read shard (:func:`..ops.sketch.
    bottom_k_sketch_batch`), and because sketches union-merge
    associatively, one ``all_gather`` of the D tiny ``u32[s]`` summaries +
    one distinct-pass replaces any pairwise reduction tree.  B must
    divide by the data-axis size.
    """
    if mesh is None:
        mesh = mesh_lib.default_mesh()
    lengths = _norm_lengths(lengths, words.shape[0])
    return _jit_sketch(k, s, canonical, mesh)(words, lengths)


class ShardedCodec:
    """A codec model bound to a mesh: shard-in, shard-out batch codec.

    Produces sharded device arrays (`jax.device_put` with a NamedSharding on
    the batch axis), encodes/decodes without any collective, and exposes
    `gathered_*` variants that merge results with `all_gather` when a
    replicated output is required.
    """

    def __init__(
        self,
        codec: str = "2bit",
        *,
        mesh: Mesh | None = None,
        variant: str | None = None,
        decode_variant: str | None = None,
        tier: str = "auto",
    ):
        self.mesh = mesh if mesh is not None else mesh_lib.default_mesh()
        self.codec = codec
        self.variant = variant
        self.decode_variant = decode_variant
        self.tier = tier
        axis = mesh_lib.DATA_AXIS
        self.batch_sharding = NamedSharding(self.mesh, P(axis, None))
        self.replicated = NamedSharding(self.mesh, P(None, None))

    def shard(self, host_batch) -> jax.Array:
        """Place a host u8[B, L] batch sharded over the data axis."""
        return jax.device_put(host_batch, self.batch_sharding)

    def encode(self, reads: jax.Array, gather: bool = False) -> jax.Array:
        return (
            data_parallel_encode(
                reads,
                mesh=self.mesh,
                codec=self.codec,
                variant=self.variant,
                tier=self.tier,
                gather=gather,
            )
        )

    def decode(self, words: jax.Array, gather: bool = False) -> jax.Array:
        return data_parallel_decode(
            words,
            mesh=self.mesh,
            codec=self.codec,
            variant=self.decode_variant,
            tier=self.tier,
            gather=gather,
        )

    def encode_checked(
        self, reads: jax.Array, gather: bool = False
    ) -> tuple[jax.Array, jax.Array]:
        """Sharded encode + input-validity flag (see
        :func:`data_parallel_encode_checked`)."""
        return data_parallel_encode_checked(
            reads,
            mesh=self.mesh,
            codec=self.codec,
            variant=self.variant,
            tier=self.tier,
            gather=gather,
        )

    def decode_checked(self, words: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Sharded decode + integrity flag (base-5 only; see
        :func:`data_parallel_decode_checked`)."""
        if self.codec != "base5":
            raise ValueError(
                "decode_checked is base-5 only: every 2-bit pattern decodes, "
                "there is no invalid state to detect"
            )
        return data_parallel_decode_checked(
            words, mesh=self.mesh, tier=self.tier
        )


@functools.lru_cache(maxsize=None)
def _jit_edit_distances(codec: str, mesh: Mesh):
    from ..ops import align as align_lib

    axis = mesh_lib.DATA_AXIS
    fn = (
        align_lib.edit_distance_packed_b5
        if codec == "base5"
        else align_lib.edit_distance_packed
    )

    def per_shard(qw, ql, tw, tl):
        d = fn(qw, ql, tw, tl)
        return jax.lax.all_gather(d, axis, axis=0, tiled=True)

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis), P(axis, None), P(axis)),
            out_specs=P(None),
            check_vma=False,
        )
    )


def edit_distances(
    qwords: jax.Array,
    qlens,
    twords: jax.Array,
    tlens,
    *,
    mesh: Mesh | None = None,
    codec: str = "2bit",
) -> jax.Array:
    """Distributed batched edit distance: pair rows sharded over the data
    axis (pairs are independent — pure data parallelism), global
    Levenshtein per pair all-gathered to a replicated i32[B].
    ``codec="base5"`` runs the digit-alphabet scan (``N`` literal).
    B must divide by the data-axis size."""
    if mesh is None:
        mesh = mesh_lib.default_mesh()
    B = qwords.shape[0]
    qlens = _norm_lengths(qlens, B)
    tlens = _norm_lengths(tlens, B)
    return _jit_edit_distances(codec, mesh)(qwords, qlens, twords, tlens)
