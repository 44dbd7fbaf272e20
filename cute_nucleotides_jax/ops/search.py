"""Exact pattern search on the 2-bit packed domain, with N-wildcards.

``grep`` for packed nucleotide streams: find every position where a query
(up to thousands of nt) occurs, *without decoding* — the packed stream is
read once and compared word-against-word, so the scan moves ~1/4 the bytes
of an ASCII search.  ``N``/``n`` in the query is a wildcard (matches any
nucleotide), which is what degenerate primer/adapter searches need.

A match at position ``i`` means: for every query word ``wq``,
``(window32(i + 16*wq) ^ q[wq]) & care[wq] == 0`` where ``window32(p)`` is
the 32-bit funnel window starting at nucleotide ``p`` (the same two-tap
funnel as :func:`.kmer.kmer_codes`) and ``care`` has ``0b11`` in every
non-wildcard 2-bit field.  The reference has no search op — this extends
its packed-domain toolkit (reference src/n_to_bits.rs packs LSB-first,
which is what makes the window compare a plain shift-OR; see ops/spec.py).

Two output forms:

* **Mask** (:func:`match_mask`): position-ordered boolean mask via two
  ``jnp.take`` gathers per query word.  Simple, any length.
* **Packed bitmask** (:func:`match_bits`): one funnel shift per in-word
  phase over the whole stream and static-offset slices per query word,
  producing ``u32[R, 512]`` where bit ``s`` of lane ``(r, w)`` is the
  match flag for position ``16*(512 r + w) + s`` — 16 positions per
  output word, so the result stream is as small as the input stream.  The
  query is baked into the program as constants (compiled per query).

Matching is over the *normalized* sequence (what decode emits: uppercase,
``U``→``T``) — queries may be any case and use ``U`` freely.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import spec

__all__ = [
    "compile_query",
    "revcomp_query",
    "match_mask",
    "match_bits",
    "match_count",
    "match_positions",
    "match_mask_batch",
    "match_counts_batch",
    "compile_query_b5",
    "match_mask_b5",
    "match_count_b5",
    "match_positions_b5",
    "match_mask_b5_batch",
]

#: query bytes allowed (N/n are wildcards; everything else must be ACGTU)
_QUERY_OK = frozenset(b"ACGTUacgtuNn")


def compile_query(query: bytes) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack an ASCII query into ``(q u32[Wq], care u32[Wq], m)``.

    ``q`` holds the query's 2-bit codes LSB-first (the stream packing);
    ``care`` has ``0b11`` in each concrete field and ``0b00`` in wildcard
    (``N``) fields — wildcard fields of ``q`` are 0.  Raises on bytes
    outside ``{A,C,G,T,U,N}`` (either case): a typo'd query would
    otherwise silently search for its ``(byte >> 1) & 3`` alias.
    """
    if isinstance(query, str):
        query = query.encode()
    m = len(query)
    if m == 0:
        raise ValueError("empty query")
    bad = set(query) - _QUERY_OK
    if bad:
        raise ValueError(
            f"query contains non-ACGTUN bytes: {sorted(chr(b) for b in bad)}"
        )
    wq = -(-m // spec.NT_PER_U32_2BIT)
    q = np.zeros(wq, np.uint32)
    care = np.zeros(wq, np.uint32)
    for i, b in enumerate(query):
        w, f = divmod(i, spec.NT_PER_U32_2BIT)
        if b not in b"Nn":
            q[w] |= ((b >> 1) & 3) << (2 * f)
            care[w] |= 3 << (2 * f)
    return q, care, m


def revcomp_query(query: bytes) -> bytes:
    """Reverse-complement of an ASCII query (``N`` stays ``N``); search for
    this to find reverse-strand occurrences at forward coordinates."""
    if isinstance(query, str):
        query = query.encode()
    return query.upper().replace(b"U", b"T")[::-1].translate(
        bytes.maketrans(b"ACGTN", b"TGCAN")
    )


@functools.partial(jax.jit, static_argnames=("length", "m"))
def _match_mask_impl(
    words: jax.Array, q: jax.Array, care: jax.Array, length: int, m: int
) -> jax.Array:
    n = length - m + 1
    wq_n = q.shape[0]
    padded = jnp.concatenate([words, jnp.zeros(wq_n + 1, jnp.uint32)])
    i = jnp.arange(n)
    wl = i // spec.NT_PER_U32_2BIT
    s = (2 * (i % spec.NT_PER_U32_2BIT)).astype(jnp.uint32)
    z = jnp.uint32(0)
    diff = None
    for wq in range(wq_n):
        a = jnp.take(padded, wl + wq)
        b = jnp.take(padded, wl + wq + 1)
        win = (a >> s) | jnp.where(s == 0, z, b << (32 - s))
        d = (win ^ q[wq]) & care[wq]
        diff = d if diff is None else diff | d
    return diff == 0


def match_mask(
    words: jax.Array, length: int, query: bytes
) -> jax.Array:
    """Occurrence mask of ``query`` in a packed u32[W] stream:
    -> bool[length - m + 1], entry ``i`` true iff the query matches at
    nucleotide ``i``.  Gather form — use :func:`match_bits` for the
    packed-bitmask scan."""
    if words.ndim != 1:
        raise TypeError("match_mask takes a flat u32 word stream")
    q, care, m = compile_query(query)
    if length - m + 1 <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    if length > words.shape[0] * spec.NT_PER_U32_2BIT:
        raise ValueError("length exceeds stream capacity")
    return _match_mask_impl(
        words, jnp.asarray(q), jnp.asarray(care), length, m
    )


# --- packed-bitmask scan -------------------------------------------------

#: output word lanes per bitmask row (the row's 16*W scan positions)
_SEARCH_W = 512


@functools.partial(jax.jit, static_argnames=("length", "q", "care", "m"))
def _match_bits_impl(
    words: jax.Array, length: int, q: tuple, care: tuple, m: int
) -> jax.Array:
    flat = words.reshape(-1)
    W = _SEARCH_W
    rows = -(-flat.shape[0] // W)
    N = rows * W
    wq_n = len(q)
    # the taps read up to wq_n + 1 words past each start word
    padded = jnp.concatenate(
        [flat, jnp.zeros(N - flat.shape[0] + wq_n + 1, jnp.uint32)]
    )
    bits = jnp.zeros(N, jnp.uint32)
    for s in range(spec.NT_PER_U32_2BIT):
        win = padded[: N + wq_n]
        if s:
            win = (win >> (2 * s)) | (padded[1 : N + wq_n + 1] << (32 - 2 * s))
        diff = None
        for wq in range(wq_n):
            if not care[wq]:
                continue  # all-wildcard query word matches everywhere
            d = (win[wq : wq + N] ^ jnp.uint32(q[wq])) & jnp.uint32(care[wq])
            diff = d if diff is None else diff | d
        hit = jnp.ones(N, bool) if diff is None else diff == 0
        bits = bits | jnp.where(hit, jnp.uint32(1 << s), jnp.uint32(0))
    # clear starts past the last valid one: lane w covers [16 w, 16 w + 16)
    v = jnp.clip(length - m + 1 - 16 * jnp.arange(N, dtype=jnp.int32), 0, 16)
    bits = bits & ((jnp.uint32(1) << v.astype(jnp.uint32)) - 1)
    return bits.reshape(rows, W)


def match_bits(words: jax.Array, length: int, query: bytes) -> jax.Array:
    """Packed occurrence bitmask of ``query``: -> u32[rows, 512] where bit
    ``s`` of lane ``(r, w)`` flags a match at nucleotide
    ``16*(512 r + w) + s``.  The packed bitmask is the same word count as
    the input (1/4 of the ASCII byte stream)."""
    if words.ndim != 1:
        raise TypeError("match_bits takes a flat u32 word stream")
    q, care, m = compile_query(query)
    if length - m + 1 <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    if length > words.shape[0] * spec.NT_PER_U32_2BIT:
        raise ValueError("length exceeds stream capacity")
    return _match_bits_impl(
        words, length, tuple(int(v) for v in q), tuple(int(v) for v in care), m
    )


def match_count(words: jax.Array, length: int, query: bytes) -> jax.Array:
    """Number of occurrences of ``query`` (scalar i32, on device)."""
    bits = match_bits(words, length, query)
    return jax.lax.population_count(bits).sum().astype(jnp.int32)


def match_positions(words: jax.Array, length: int, query: bytes) -> np.ndarray:
    """Sorted occurrence positions (host ndarray) — the `grep` output form."""
    bits = np.asarray(match_bits(words, length, query))
    r, w = np.nonzero(bits)
    pos = []
    for ri, wi in zip(r, w):
        b = int(bits[ri, wi])
        base = 16 * (ri * bits.shape[1] + wi)
        pos.extend(base + s for s in range(16) if (b >> s) & 1)
    return np.asarray(sorted(pos), dtype=np.int64)


# --- batched search ----------------------------------------------------------
# The streaming pipeline's unit is a padded batch of independent reads
# (u8[B, L] -> packed u32[B, W]); the batched scans run the single-stream
# match per row under vmap (rows never see each other's words) and mask
# ragged tails with the true per-read lengths — same shape discipline as
# kmer_histogram_batch.


def _ragged_mask(mask: jax.Array, lengths: jax.Array, m: int) -> jax.Array:
    i = jax.lax.broadcasted_iota(jnp.int32, mask.shape, 1)
    return mask & (i < (lengths - (m - 1))[:, None])


@functools.partial(jax.jit, static_argnames=("qt", "ct", "m"))
def _match_mask_batch_impl(
    words: jax.Array, lengths: jax.Array, qt: tuple, ct: tuple, m: int
) -> jax.Array:
    q = jnp.asarray(np.array(qt, np.uint32))
    care = jnp.asarray(np.array(ct, np.uint32))
    cap = words.shape[1] * spec.NT_PER_U32_2BIT
    mask = jax.vmap(lambda w: _match_mask_impl(w, q, care, cap, m))(words)
    return _ragged_mask(mask, lengths, m)


def _norm_lengths(lengths, B: int) -> jax.Array:
    return jnp.broadcast_to(jnp.asarray(lengths, jnp.int32).reshape(-1), (B,))


def match_mask_batch(words: jax.Array, lengths, query: bytes) -> jax.Array:
    """Occurrence mask of ``query`` in each row of a packed 2-bit batch:
    u32[B, W] + lengths -> bool[B, 16 W - m + 1]; entry ``(b, i)`` true iff
    the query matches read ``b`` at position ``i`` (positions past
    ``lengths[b] - m`` are always false)."""
    if words.ndim != 2:
        raise TypeError("match_mask_batch takes a packed u32[B, W] batch")
    q, care, m = compile_query(query)
    if words.shape[1] * spec.NT_PER_U32_2BIT - m + 1 <= 0:
        raise ValueError(f"row capacity shorter than query ({m})")
    return _match_mask_batch_impl(
        words,
        _norm_lengths(lengths, words.shape[0]),
        tuple(int(v) for v in q),
        tuple(int(v) for v in care),
        m,
    )


@functools.partial(jax.jit, static_argnames=("qc", "m"))
def _match_mask_b5_batch_impl(
    words: jax.Array, lengths: jax.Array, qc: tuple, m: int
) -> jax.Array:
    cap = (words.shape[1] // 2) * spec.NT_PER_WORD_B5
    mask = jax.vmap(lambda w: _match_mask_b5_impl(w, cap, qc, m))(words)
    return _ragged_mask(mask, lengths, m)


def match_mask_b5_batch(words: jax.Array, lengths, query: bytes) -> jax.Array:
    """Batched :func:`match_mask_b5`: interleaved u32[B, 2 Wb] + lengths ->
    bool[B, 27 Wb - m + 1] (``N`` literal, ``?`` wildcard)."""
    if words.ndim != 2 or words.shape[1] % 2:
        raise TypeError(
            "match_mask_b5_batch takes an interleaved u32[B, 2W] batch"
        )
    m = len(query)
    if (words.shape[1] // 2) * spec.NT_PER_WORD_B5 - m + 1 <= 0:
        raise ValueError(f"row capacity shorter than query ({m})")
    return _match_mask_b5_batch_impl(
        words, _norm_lengths(lengths, words.shape[0]), _qc_host(query), m
    )


def match_counts_batch(
    words: jax.Array, lengths, query: bytes, *, codec: str = "2bit"
) -> jax.Array:
    """Per-read occurrence counts: -> i32[B] (on device)."""
    fn = match_mask_batch if codec == "2bit" else match_mask_b5_batch
    return jnp.sum(fn(words, lengths, query), axis=1).astype(jnp.int32)


# --- base-5 codec ------------------------------------------------------------
# The base-5 stream has a REAL ``N`` symbol, so ``N`` in a base-5 query is a
# literal (matches stream N exactly) and the wildcard is ``?``.  Matching
# works at the TRIPLET level: each packed 7-bit value v = a + 5b + 25c is
# converted once to the digit-isolated base-8 form ``a | b<<3 | c<<6`` (two
# exact multiply-shifts — the same Lemire constants the decoder uses,
# reference src/n_to_bits2.rs:210-211), after which a per-digit comparison
# is a plain XOR + care mask, exactly like the 2-bit tier.  A query at
# stream position p only constrains triplets, so the scan runs three
# phase-aligned folds (p mod 3 = 0, 1, 2) over the triplet stream and
# interleaves the three masks.

_QUERY_B5_OK = frozenset(b"ACGTUNacgtun?")


def compile_query_b5(
    query: bytes,
) -> tuple[tuple[np.ndarray, np.ndarray], ...]:
    """Pack an ASCII base-5 query into three phase-aligned
    ``(q8 u32[T], care8 u32[T])`` tables (phase = start position mod 3).

    ``q8[j]`` holds the query digits covering stream triplet ``j`` in
    base-8 slots (3 bits per digit); ``care8`` has ``0b111`` per concrete
    slot and 0 for ``?`` wildcards and slots outside the query.  Raises on
    bytes outside ``{A,C,G,T,U,N,?}`` (either case).
    """
    if isinstance(query, str):
        query = query.encode()
    m = len(query)
    if m == 0:
        raise ValueError("empty query")
    bad = set(query) - _QUERY_B5_OK
    if bad:
        raise ValueError(
            f"query contains non-ACGTUN? bytes: {sorted(chr(b) for b in bad)}"
        )
    digits = [
        None if b == ord("?") else int(spec.DIGIT_LUT8[b & 7])
        for b in query
    ]
    out = []
    for phase in range(3):
        T = -(-(phase + m) // 3)
        q8 = np.zeros(T, np.uint32)
        care8 = np.zeros(T, np.uint32)
        for i, d in enumerate(digits):
            if d is None:
                continue
            j, slot = divmod(phase + i, 3)
            q8[j] |= d << (3 * slot)
            care8[j] |= 7 << (3 * slot)
        out.append((q8, care8))
    return tuple(out)


def _b5_triplets_b8(words: jax.Array) -> jax.Array:
    """Interleaved base-5 u32[2W] stream -> digit-isolated triplets
    u32[9W] (``a | b<<3 | c<<6`` per triplet, stream order)."""
    lo = words[0::2]
    hi = words[1::2]
    cols = []
    for j in range(9):
        b = 7 * j
        if b + 7 <= 32:
            t = lo >> b
        elif b >= 32:
            t = hi >> (b - 32)
        else:
            t = (lo >> b) | (hi << (32 - b))
        cols.append(t & jnp.uint32(0x7F))
    v = jnp.stack(cols, axis=1).reshape(-1)
    v5 = (v * jnp.uint32(205)) >> 10
    v25 = (v * jnp.uint32(41)) >> 10
    return (v - 5 * v5) | ((v5 - 5 * v25) << 3) | (v25 << 6)


@functools.partial(jax.jit, static_argnames=("length", "qc", "m"))
def _match_mask_b5_impl(
    words: jax.Array, length: int, qc: tuple, m: int
) -> jax.Array:
    n = length - m + 1
    t8 = _b5_triplets_b8(words)
    U = -(-n // 3)  # phase-fold length (triplet starts per phase)
    Tmax = max(len(q8) for q8, _ in qc)
    pad = U + Tmax - t8.shape[0]
    if pad > 0:
        # stream triplets past capacity read as 0 ('AAA'); masked below
        t8 = jnp.concatenate([t8, jnp.zeros(pad, jnp.uint32)])
    phase_masks = []
    for phase in range(3):
        q8, care8 = qc[phase]
        diff = None
        for j in range(len(q8)):
            cj = int(care8[j])
            if not cj:
                continue
            d = (t8[j : j + U] ^ jnp.uint32(int(q8[j]))) & jnp.uint32(cj)
            diff = d if diff is None else diff | d
        phase_masks.append(
            jnp.ones(U, bool) if diff is None else diff == 0
        )
    mask = jnp.stack(phase_masks, axis=1).reshape(-1)[:n]
    # positions past the last valid start were folded from padded/overhang
    # triplets; the [:n] truncation above is exact because position
    # p = 3u + phase lands at flat index 3u + phase
    return mask


def match_mask_b5(words: jax.Array, length: int, query: bytes) -> jax.Array:
    """Occurrence mask of ``query`` in a base-5 packed u32[2W] interleaved
    stream: -> bool[length - m + 1].  ``N`` in the query is a literal
    (base-5 has a real N digit); ``?`` is the any-nucleotide wildcard."""
    if words.ndim != 1 or words.shape[0] % 2:
        raise TypeError(
            "match_mask_b5 takes a flat interleaved u32[2W] stream"
        )
    m = len(query)
    if length - m + 1 <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    if length > (words.shape[0] // 2) * spec.NT_PER_WORD_B5:
        raise ValueError("length exceeds stream capacity")
    return _match_mask_b5_impl(words, length, _qc_host(query), m)


# --- base-5 packed-bitmask scan ------------------------------------------
# The 2-bit scan's packed output for base-5 streams: one u32 of 27 match
# bits per u64 word — the result stream is half the size of the input words.


def _qc_host(query: bytes) -> tuple:
    qc = compile_query_b5(query)
    return tuple(
        (tuple(int(v) for v in q8), tuple(int(v) for v in c8))
        for q8, c8 in qc
    )


@functools.partial(jax.jit, static_argnames=("length", "qc", "m"))
def _match_bits_b5_impl(
    words: jax.Array, length: int, qc: tuple, m: int
) -> jax.Array:
    flat = words.reshape(-1)
    W = _SEARCH_W
    rows = -(-(flat.shape[0] // 2) // W)
    mask = _match_mask_b5_impl(flat, length, qc, m)
    mask = jnp.pad(mask, (0, rows * W * spec.NT_PER_WORD_B5 - mask.shape[0]))
    lanes = mask.reshape(rows * W, spec.NT_PER_WORD_B5).astype(jnp.uint32)
    sh = jnp.arange(spec.NT_PER_WORD_B5, dtype=jnp.uint32)
    bits = jnp.sum(lanes << sh, axis=1, dtype=jnp.uint32)
    return bits.reshape(rows, W)


def match_bits_b5(words: jax.Array, length: int, query: bytes) -> jax.Array:
    """Packed occurrence bitmask of ``query`` in a base-5 interleaved
    stream: -> u32[rows, 512] where bit ``b`` of lane ``(r, w)`` flags a
    match at nucleotide ``27*(512 r + w) + b`` (``b < 27``).  ``N`` is a
    literal, ``?`` the wildcard, as in :func:`match_mask_b5`."""
    if words.ndim != 1 or words.shape[0] % 2:
        raise TypeError("match_bits_b5 takes a flat interleaved u32[2W] stream")
    m = len(query)
    qc = _qc_host(query)
    if length - m + 1 <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    if length > (words.shape[0] // 2) * spec.NT_PER_WORD_B5:
        raise ValueError("length exceeds stream capacity")
    return _match_bits_b5_impl(words, length, qc, m)


def match_count_b5(words: jax.Array, length: int, query: bytes) -> jax.Array:
    """Number of occurrences of ``query`` in a base-5 stream (i32, device)."""
    return jnp.sum(match_mask_b5(words, length, query)).astype(jnp.int32)


def match_positions_b5(
    words: jax.Array, length: int, query: bytes
) -> np.ndarray:
    """Sorted occurrence positions in a base-5 stream (host ndarray)."""
    mask = np.asarray(match_mask_b5(words, length, query))
    return np.nonzero(mask)[0].astype(np.int64)
