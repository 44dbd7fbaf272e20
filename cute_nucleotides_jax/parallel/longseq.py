"""Block-sharded long-sequence encoding ("context parallelism" for a codec).

The reference's longest tested input is one 40,000-nt buffer in one core
(reference benches/bench_n_to_bits.rs:10).  For chromosome-scale sequences the
device-mesh move is to split ONE sequence across the mesh at word-aligned
boundaries and encode shards independently — the packed words then concatenate
bit-exactly because both codecs are stateless per word:

* 2-bit: words cover disjoint 32-nt spans (reference src/n_to_bits.rs:38-43),
  so any 32-aligned split point is safe.  Device shards use 16-nt u32 words;
  split points must be 32-aligned so u32 pairs stay in order.
* base-5: words cover disjoint 27-nt spans (reference src/n_to_bits2.rs:44-47)
  and a triplet never crosses a word, so 27-aligned splits are safe.  Note
  27 does not divide typical power-of-two shard sizes — the alignment here is
  the nontrivial part the reference never faces (SURVEY.md §2.3).

The shard axis is the mesh's ``"seq"`` axis.  Encoding is collective-free;
``gather=True`` merges shard outputs with `all_gather` over the mesh so every
device holds the whole packed sequence.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import spec
from . import mesh as mesh_lib


def shard_points_2bit(length: int, n_shards: int) -> list[int]:
    """Word-aligned split offsets for a 2-bit encode over ``n_shards``.

    Each interior boundary is a multiple of 32 nt so every shard owns whole
    u64 words; shards are balanced to within one word.
    """
    words = spec.num_words_2bit(length)
    return [
        min(32 * ((words * k) // n_shards), length) for k in range(n_shards + 1)
    ]


def shard_points_b5(length: int, n_shards: int) -> list[int]:
    """27-aligned split offsets for a base-5 encode over ``n_shards``."""
    words = spec.num_words_b5(length)
    return [
        min(27 * ((words * k) // n_shards), length) for k in range(n_shards + 1)
    ]


def _pad_and_stack(seq: np.ndarray, points: list[int], block: int) -> tuple[np.ndarray, int]:
    """Cut ``seq`` at ``points`` and stack shards into u8[S, Lmax] ('A'-padded)."""
    n_shards = len(points) - 1
    lmax = max(points[k + 1] - points[k] for k in range(n_shards))
    lmax = spec.cdiv(max(lmax, 1), block) * block
    out = np.full((n_shards, lmax), ord("A"), dtype=np.uint8)
    for k in range(n_shards):
        piece = seq[points[k] : points[k + 1]]
        out[k, : piece.size] = piece
    return out, lmax


@functools.lru_cache(maxsize=None)
def _jit_shard_encode(codec: str, mesh: Mesh, gather: bool):
    axis = mesh_lib.SEQ_AXIS
    from . import data_parallel

    from ..models import default_encode_variant

    # the tier's fastest variant
    fn = data_parallel._encode_fn(codec, default_encode_variant("auto"), "auto")

    def per_shard(x):  # x: u8[1, Lmax] on each device
        out = fn(x)
        if gather:
            out = jax.lax.all_gather(out, axis, axis=0, tiled=True)
        return out

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None),),
            out_specs=P(None if gather else axis, None),
            check_vma=False,
        )
    )


def _encode_long(seq, codec: str, mesh: Mesh | None):
    if mesh is None:
        mesh = mesh_lib.make_mesh(data=1, seq=len(jax.devices()))
    n_shards = mesh.shape[mesh_lib.SEQ_AXIS]
    seq = np.frombuffer(bytes(seq), dtype=np.uint8) if isinstance(
        seq, (bytes, bytearray)
    ) else np.asarray(seq, dtype=np.uint8)
    length = seq.size

    if codec == "2bit":
        points = shard_points_2bit(length, n_shards)
        block, words_for = spec.NT_PER_WORD_2BIT, spec.num_words_2bit
    else:
        points = shard_points_b5(length, n_shards)
        block, words_for = spec.NT_PER_WORD_B5, spec.num_words_b5

    batch, lmax = _pad_and_stack(seq, points, block)
    sharding = NamedSharding(mesh, P(None, mesh_lib.SEQ_AXIS, None))
    x = jax.device_put(
        batch.reshape(1, n_shards, lmax), sharding
    ).reshape(n_shards, lmax)
    out = _jit_shard_encode(codec, mesh, True)(x)
    out_np = np.asarray(out)  # (n_shards, 2*words(lmax)) u32

    # stitch: shard k contributes words for its real span only
    pieces = []
    for k in range(n_shards):
        w = words_for(points[k + 1] - points[k])
        pieces.append(out_np[k, : 2 * w])
    allw = np.concatenate(pieces) if pieces else np.zeros(0, np.uint32)
    total = words_for(length)
    return spec.u32_pairs_to_u64(allw.reshape(-1)[: 2 * total])


def encode_long_2bit(seq, *, mesh: Mesh | None = None) -> np.ndarray:
    """Encode one long sequence 2-bit, sharded over the mesh's seq axis.

    Returns the same u64 word stream as the single-device encoder — shard
    outputs concatenate bit-exactly thanks to 32-aligned boundaries.
    """
    return _encode_long(seq, "2bit", mesh)


def encode_long_b5(seq, *, mesh: Mesh | None = None) -> np.ndarray:
    """Encode one long sequence base-5, sharded at 27-aligned boundaries."""
    return _encode_long(seq, "base5", mesh)


@functools.lru_cache(maxsize=None)
def _jit_shard_decode(codec: str, mesh: Mesh):
    axis = mesh_lib.SEQ_AXIS
    from . import data_parallel

    from ..models import default_decode_variant

    fn = data_parallel._decode_fn(codec, default_decode_variant("auto"), "auto")

    return jax.jit(
        shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(axis, None),),
            out_specs=P(axis, None),
            check_vma=False,
        )
    )


def _decode_long(bits, length: int, codec: str, mesh: Mesh | None):
    if mesh is None:
        mesh = mesh_lib.make_mesh(data=1, seq=len(jax.devices()))
    n_shards = mesh.shape[mesh_lib.SEQ_AXIS]
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    per_word = spec.NT_PER_WORD_2BIT if codec == "2bit" else spec.NT_PER_WORD_B5
    if length > bits.size * per_word:
        raise ValueError(f"length {length} exceeds capacity {bits.size * per_word}")

    # balanced word split; pad each shard to the max shard word count
    points = [(bits.size * k) // n_shards for k in range(n_shards + 1)]
    wmax = max((points[k + 1] - points[k] for k in range(n_shards)), default=1)
    wmax = max(wmax, 1)
    padded = np.zeros((n_shards, 2 * wmax), dtype=np.uint32)
    for k in range(n_shards):
        piece = spec.u64_to_u32_pairs(bits[points[k] : points[k + 1]]).reshape(-1)
        padded[k, : piece.size] = piece
    sharding = NamedSharding(mesh, P(None, mesh_lib.SEQ_AXIS, None))
    x = jax.device_put(
        padded.reshape(1, n_shards, 2 * wmax), sharding
    ).reshape(n_shards, 2 * wmax)
    out = np.asarray(_jit_shard_decode(codec, mesh)(x))  # (n_shards, wmax*nt)

    pieces = []
    for k in range(n_shards):
        w = points[k + 1] - points[k]
        pieces.append(out[k, : w * per_word])
    full = np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
    return full[:length]


def _shard_stream_words(w32: np.ndarray, mesh: Mesh, w_eq: int):
    """Pad a u32 stream to ``S * w_eq`` and lay it out one block per
    seq-axis device (shared by :func:`match_long` / :func:`best_match_long`)."""
    S = mesh.shape[mesh_lib.SEQ_AXIS]
    pad = S * w_eq - w32.size
    if pad:
        w32 = np.concatenate([w32, np.zeros(pad, np.uint32)])
    sharding = NamedSharding(mesh, P(None, mesh_lib.SEQ_AXIS, None))
    return jax.device_put(w32.reshape(1, S, w_eq), sharding).reshape(S, w_eq)


@functools.lru_cache(maxsize=None)
def _jit_shard_match(mesh: Mesh, q: tuple, care: tuple, m: int, w_eq: int):
    axis = mesh_lib.SEQ_AXIS
    from ..ops import search as search_ops

    S = mesh.shape[axis]
    H = len(q) + 1  # words a window can read past its start word

    def per_shard(w):  # u32[1, w_eq] — this shard's block of the stream
        flat = w.reshape(-1)
        # halo: the NEXT shard's first H words (ring ppermute);
        # the last shard's wrap-around halo is never read by a valid
        # window (they end inside the real stream — see match_long)
        head = jax.lax.slice(flat, (0,), (H,))
        halo = jax.lax.ppermute(
            head, axis, [((i + 1) % S, i) for i in range(S)]
        )
        ext = jnp.concatenate([flat, halo])
        # claim every position starting in this block: n_local = 16*w_eq
        bits = search_ops._match_bits_impl(ext, 16 * w_eq + m - 1, q, care, m)
        return bits.reshape(-1)[:w_eq].reshape(1, w_eq)

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None),),
            out_specs=P(axis, None),
            check_vma=False,
        )
    )


def match_long(bits, length: int, query: bytes, *, mesh: Mesh | None = None) -> np.ndarray:
    """Find every occurrence of ``query`` in ONE long 2-bit stream, the word
    stream block-sharded over the mesh's seq axis (``ops.search`` semantics:
    ``N`` in the query is a wildcard).  Returns sorted global positions.

    Each shard scans its own words; windows crossing a shard boundary read
    a ``ppermute``-exchanged halo of the successor shard's head words, so
    no hit is lost at boundaries and no position is double-counted (a
    position belongs to the shard owning its start word).
    """
    from ..ops import search as search_ops

    if mesh is None:
        mesh = mesh_lib.make_mesh(data=1, seq=len(jax.devices()))
    S = mesh.shape[mesh_lib.SEQ_AXIS]
    q, care, m = search_ops.compile_query(query)
    n = length - m + 1
    if n <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if length > bits.size * spec.NT_PER_WORD_2BIT:
        raise ValueError("length exceeds stream capacity")
    w32 = spec.u64_to_u32_pairs(bits).reshape(-1)
    W = w32.size
    w_eq = max(-(-W // S), len(q) + 1)  # one halo must cover the overhang
    x = _shard_stream_words(w32, mesh, w_eq)
    out = np.asarray(
        _jit_shard_match(mesh, tuple(map(int, q)), tuple(map(int, care)), m, w_eq)(x)
    ).reshape(-1)
    # global tail mask: clear claimed positions past the last valid start
    lane_base = 16 * np.arange(out.size, dtype=np.int64)
    v = np.clip(n - lane_base, 0, 16).astype(np.uint32)
    out = out & ((np.uint32(1) << v) - np.uint32(1))
    w_idx, = np.nonzero(out)
    pos = [
        int(16 * w + s)
        for w in w_idx
        for s in range(16)
        if (int(out[w]) >> s) & 1
    ]
    return np.asarray(pos, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _jit_shard_match_b5(mesh: Mesh, qc: tuple, m: int, weq_words: int):
    axis = mesh_lib.SEQ_AXIS
    from ..ops import search as search_ops

    S = mesh.shape[axis]
    H = -(-(m - 1) // 27) + 1  # halo u64 words a window can read past its block

    def per_shard(w):  # u32[1, 2*weq_words] — this shard's interleaved block
        flat = w.reshape(-1)
        head = jax.lax.slice(flat, (0,), (2 * H,))
        halo = jax.lax.ppermute(
            head, axis, [((i + 1) % S, i) for i in range(S)]
        )
        ext = jnp.concatenate([flat, halo])
        # claim every position starting in this block (27 per word); the
        # +m-1 lets end-of-block windows read into the halo
        bits = search_ops._match_bits_b5_impl(ext, 27 * weq_words + m - 1, qc, m)
        return bits.reshape(-1)[:weq_words].reshape(1, weq_words)

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None),),
            out_specs=P(axis, None),
            check_vma=False,
        )
    )


def match_long_b5(
    bits, length: int, query: bytes, *, mesh: Mesh | None = None
) -> np.ndarray:
    """Find every occurrence of ``query`` in ONE long base-5 stream, the
    word stream block-sharded over the mesh's seq axis (``ops.search``
    base-5 semantics: ``N`` literal, ``?`` wildcard).  Returns sorted
    global positions.

    The 27∤2^k mirror of :func:`match_long`: each shard owns whole u64
    words (27 nt each) and runs the packed-bitmask scan
    (:func:`..ops.search.match_bits_b5`) on its block extended by a
    ``ppermute``-exchanged halo of the successor's head words, so hits
    crossing shard boundaries are seen exactly once (a position belongs
    to the shard owning its start word).
    """
    from ..ops import search as search_ops

    if mesh is None:
        mesh = mesh_lib.make_mesh(data=1, seq=len(jax.devices()))
    S = mesh.shape[mesh_lib.SEQ_AXIS]
    m = len(query)
    qc = search_ops._qc_host(query)
    n = length - m + 1
    if n <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if length > bits.size * spec.NT_PER_WORD_B5:
        raise ValueError("length exceeds stream capacity")
    w32 = spec.u64_to_u32_pairs(bits.reshape(1, -1)).reshape(-1)
    H = -(-(m - 1) // 27) + 1
    weq_words = max(-(-bits.size // S), H)  # one halo must cover the overhang
    x = _shard_stream_words(w32, mesh, 2 * weq_words)
    out = np.asarray(
        _jit_shard_match_b5(mesh, qc, m, weq_words)(x)
    ).reshape(-1)
    # global tail mask: clear claimed positions past the last valid start
    lane_base = 27 * np.arange(out.size, dtype=np.int64)
    v = np.clip(n - lane_base, 0, 27).astype(np.uint32)
    out = out & ((np.uint32(1) << v) - np.uint32(1))
    w_idx, = np.nonzero(out)
    pos = [
        int(27 * w + s)
        for w in w_idx
        for s in range(27)
        if (int(out[w]) >> s) & 1
    ]
    return np.asarray(pos, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _jit_shard_best_match(
    mesh: Mesh, peq_key: tuple, m: int, w_eq: int, H: int
):
    axis = mesh_lib.SEQ_AXIS
    from ..ops import align as align_ops

    S = mesh.shape[axis]
    nb = len(peq_key) // 4
    peq_np = np.asarray(peq_key, np.uint32).reshape(4, nb)
    plan = align_ops.stream_rows_plan(w_eq + H, m)

    def per_shard(w, valid):  # u32[1, w_eq], i32[1] (this shard's nt)
        flat = w.reshape(-1)
        # halo: the NEXT shard's head words (ring ppermute); any
        # occurrence strictly better than the trivial distance m spans
        # <= 2m - 1 nt (ops.align.halo_words), so the halo makes every
        # occurrence fully visible to the shard owning its start.  The
        # last shard's wrap-around halo is frozen out by its valid clamp
        # (computed on the host in int64: shard-LOCAL positions fit i32,
        # global ones need not — they are assembled host-side).
        head = jax.lax.slice(flat, (0,), (H,))
        halo = jax.lax.ppermute(
            head, axis, [((i + 1) % S, i) for i in range(S)]
        )
        ext = jnp.concatenate([flat, halo])
        d, e = align_ops._best_match_stream_impl(
            jnp.asarray(peq_np), ext, valid.reshape(()), m, plan
        )
        return d.reshape(1, 1), e.reshape(1, 1)

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis)),
            out_specs=(P(axis, None), P(axis, None)),
            check_vma=False,
        )
    )


def best_match_long(
    bits, length: int, query: bytes, *, mesh: Mesh | None = None
) -> tuple[int, int]:
    """Best approximate occurrence of ``query`` in ONE long 2-bit stream,
    the word stream block-sharded over the mesh's seq axis (Myers
    bit-parallel semiglobal, ``ops.align`` semantics: ``N`` in the query
    matches any base).  Returns ``(dist, end)`` — the minimum edit
    distance of the full query against any substring, and the first end
    position achieving it (``(m, 0)`` when nothing beats the trivial
    empty-substring alignment).

    Each shard scans its own words plus a ``ppermute``-exchanged halo of
    the successor shard's head (2m - 2 nt: the span bound for any
    occurrence beating distance m), then splits its block into
    lane-parallel overlapping rows (:func:`..ops.align.best_match_stream`'s
    plan) — so the strictly text-sequential DP runs shard- AND
    lane-parallel.  Duplicated sightings across shards are harmless: the
    global result is the lexicographic min of per-shard bests.
    """
    from ..ops import align as align_ops

    if mesh is None:
        mesh = mesh_lib.make_mesh(data=1, seq=len(jax.devices()))
    S = mesh.shape[mesh_lib.SEQ_AXIS]
    peq, m = align_ops.peq_from_bytes(query)
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if length > bits.size * spec.NT_PER_WORD_2BIT:
        raise ValueError("length exceeds stream capacity")
    w32 = spec.u64_to_u32_pairs(bits).reshape(-1)
    W = w32.size
    H = align_ops.halo_words(m)
    w_eq = max(-(-W // S), H)  # one successor halo must suffice
    x = _shard_stream_words(w32, mesh, w_eq)
    # per-shard valid nt, computed host-side in int64 so global streams
    # >= 2^31 nt stay exact (match_long's convention); the clamped
    # shard-LOCAL values always fit i32
    valid = np.clip(
        np.int64(length)
        - spec.NT_PER_U32_2BIT * np.int64(w_eq) * np.arange(S, dtype=np.int64),
        0,
        spec.NT_PER_U32_2BIT * (w_eq + H),
    ).astype(np.int32)
    step = _jit_shard_best_match(
        mesh, tuple(map(int, peq.reshape(-1))), m, w_eq, H
    )
    d, e = step(
        x,
        jax.device_put(valid, NamedSharding(mesh, P(mesh_lib.SEQ_AXIS))),
    )
    d = np.asarray(d).reshape(-1)
    e = np.asarray(e).reshape(-1)
    best = (m, 0)
    for i in range(S):
        if int(d[i]) < best[0]:
            cand_end = spec.NT_PER_U32_2BIT * w_eq * i + int(e[i])
            best = (int(d[i]), cand_end)
        elif int(d[i]) == best[0] and best[0] < m:
            cand_end = spec.NT_PER_U32_2BIT * w_eq * i + int(e[i])
            if cand_end < best[1]:
                best = (best[0], cand_end)
    return best


@functools.lru_cache(maxsize=None)
def _jit_shard_best_match_b5(
    mesh: Mesh, peq_key: tuple, m: int, p_eq: int, Hp: int
):
    axis = mesh_lib.SEQ_AXIS
    from ..ops import align as align_ops

    S = mesh.shape[axis]
    nb = len(peq_key) // 5
    peq_np = np.asarray(peq_key, np.uint32).reshape(5, nb)
    plan = align_ops.stream_rows_plan_b5(p_eq + Hp, m)

    def per_shard(w, valid):  # u32[1, 2*p_eq], i32[1]
        flat = w.reshape(-1)
        head = jax.lax.slice(flat, (0,), (2 * Hp,))
        halo = jax.lax.ppermute(
            head, axis, [((i + 1) % S, i) for i in range(S)]
        )
        ext = jnp.concatenate([flat, halo])
        d, e = align_ops._best_match_stream_impl_b5(
            jnp.asarray(peq_np), ext, valid.reshape(()), m, plan
        )
        return d.reshape(1, 1), e.reshape(1, 1)

    return jax.jit(
        shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis)),
            out_specs=(P(axis, None), P(axis, None)),
            check_vma=False,
        )
    )


def best_match_long_b5(
    bits, length: int, query: bytes, *, mesh: Mesh | None = None
) -> tuple[int, int]:
    """Base-5 mirror of :func:`best_match_long`: approximate search over
    ONE long base-5 stream, pair-aligned shards on the seq axis (``N``
    literal, ``?`` wildcard)."""
    from ..ops import align as align_ops

    if mesh is None:
        mesh = mesh_lib.make_mesh(data=1, seq=len(jax.devices()))
    S = mesh.shape[mesh_lib.SEQ_AXIS]
    peq, m = align_ops.peq_from_bytes_b5(query)
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if length > bits.size * spec.NT_PER_WORD_B5:
        raise ValueError("length exceeds stream capacity")
    w32 = spec.u64_to_u32_pairs(bits).reshape(-1)
    Wp = w32.size // 2
    Hp = max(1, -(-(2 * m - 2) // spec.NT_PER_WORD_B5))
    p_eq = max(-(-Wp // S), Hp)
    x = _shard_stream_words(w32, mesh, 2 * p_eq)
    valid = np.clip(
        np.int64(length)
        - spec.NT_PER_WORD_B5 * np.int64(p_eq) * np.arange(S, dtype=np.int64),
        0,
        spec.NT_PER_WORD_B5 * (p_eq + Hp),
    ).astype(np.int32)
    step = _jit_shard_best_match_b5(
        mesh, tuple(map(int, peq.reshape(-1))), m, p_eq, Hp
    )
    d, e = step(
        x,
        jax.device_put(valid, NamedSharding(mesh, P(mesh_lib.SEQ_AXIS))),
    )
    d = np.asarray(d).reshape(-1)
    e = np.asarray(e).reshape(-1)
    best = (m, 0)
    for i in range(S):
        if int(d[i]) < best[0]:
            best = (int(d[i]), spec.NT_PER_WORD_B5 * p_eq * i + int(e[i]))
        elif int(d[i]) == best[0] and best[0] < m:
            cand = spec.NT_PER_WORD_B5 * p_eq * i + int(e[i])
            if cand < best[1]:
                best = (best[0], cand)
    return best


def decode_long_2bit(bits, length: int, *, mesh: Mesh | None = None) -> np.ndarray:
    """Decode a long 2-bit word stream, words sharded over the seq axis."""
    return _decode_long(bits, length, "2bit", mesh)


def decode_long_b5(bits, length: int, *, mesh: Mesh | None = None) -> np.ndarray:
    """Decode a long base-5 word stream, words sharded over the seq axis."""
    return _decode_long(bits, length, "base5", mesh)
