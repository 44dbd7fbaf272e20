"""Batched edit distance on the 2-bit packed domain (Myers bit-parallel).

The reference's thesis is that packing nucleotides unlocks word-parallel
(SWAR) sequence operations (reference README.md:1-40); its toolkit stops at
codecs.  This module carries the thesis to the canonical payoff: Levenshtein
edit distance via Myers' bit-parallel algorithm (Myers 1999, in Hyyro 2003's
formulation), computed for a whole *batch* of pairs at once — one pair per
vector lane, 32 DP rows per u32 block, so every vector op advances ``32 * B``
DP cells.  No decode pass: the per-code query bitmasks (``Peq``) are built
straight from the packed 2-bit words with the same SWAR folds the codecs
use, and the text is consumed PACKED — the scan iterates words, each step
advancing 16 DP columns (27 for base-5) from one u32 load per pair, so no
unpacked codes array ever hits HBM and the loop count drops 16x/27x.

One scan, the full edlib anchoring menu and more:

* **global / NW** (:func:`edit_distance_packed`): full-sequence
  Levenshtein distance per pair — ``D[m][n]`` with unit costs.
* **semiglobal / HW** (:func:`best_match_packed`): the best approximate
  occurrence of each query anywhere in its text (``D[0][j] = 0``), with
  the first end position — the approximate-matching counterpart of the
  exact scanner in :mod:`.search`; :func:`match_ends_packed` reports
  EVERY end within a threshold instead of the best.
* **prefix / SHW** (:func:`prefix_distance_packed`): query vs the best
  text prefix (adapter/primer trimming).
* **base-5 mirrors** (``*_b5``): the same scan over the 5-digit alphabet
  (``N`` literal, ``?`` wildcard in byte queries).
* **one long stream** (:func:`best_match_stream`, ``_b5``): the span
  bound ``d >= |span - m|`` lets overlapping rows with a ``2m - 2`` nt
  halo see every occurrence worth reporting, so the text-sequential DP
  runs lane-parallel; ``parallel.longseq.best_match_long`` adds a
  mesh-shard level with a ppermute halo.
* **host tiers**: NumPy DP oracles (the test ground truth), the u64 C++
  mirror in ``native/codec.cpp`` (latency path), and
  :func:`semiglobal_traceback` — a tiny windowed DP that upgrades any
  reported ``(dist, end)`` to ``(start, SAM CIGAR)``.

Queries and texts are compared over *normalized* codes (uppercase, U->T:
the ``(byte >> 1) & 3`` fold of ops/spec.py), so 'a' == 'A' and 'U' == 'T'.
Multi-block queries (m > 32) propagate the adder carry and the shift
carry-bit across u32 blocks per text step; the block count is static from
the query-word count, so the block loop unrolls at trace time.

The DP recurrence is strictly sequential along the text, so the device mapping
puts the parallelism where it exists: across pairs (lanes) and query rows
(bits).  A ``lax.scan`` carries ``(PV, MV, score)`` per lane; each char
column is ~40 lane-ops per 32-row block (selects, carry chain, score
bit and ragged-length freeze included), i.e. ~1.3 lane-ops per DP cell.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import spec

__all__ = [
    "peq_from_packed",
    "peq_from_bytes",
    "peq_from_bytes_b5",
    "edit_distance_packed",
    "edit_distance_packed_b5",
    "best_match_packed",
    "best_match_packed_b5",
    "prefix_distance_packed",
    "match_ends_packed",
    "match_ends_peq",
    "best_match_peq",
    "best_match_peq_b5",
    "best_match_stream",
    "best_match_stream_b5",
    "edit_distance_reference",
    "edit_distance_reference_b5",
    "best_match_reference",
    "prefix_distance_reference",
    "best_match_reference_b5",
    "semiglobal_traceback",
    "semiglobal_traceback_b5",
]

_U1 = jnp.uint32(1)
_FULL = jnp.uint32(0xFFFFFFFF)

#: query rows per bit-vector block
ROWS_PER_BLOCK = 32


def _compress_even_bits(x: jax.Array) -> jax.Array:
    """Gather the 16 even-position bits of each u32 into its low 16 bits.

    Input bits must already be masked to ``0x55555555`` positions; the
    classic SWAR fold (a fixed-pattern pext) in 8 vector ops.
    """
    x = (x | (x >> 1)) & jnp.uint32(0x33333333)
    x = (x | (x >> 2)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x >> 4)) & jnp.uint32(0x00FF00FF)
    x = (x | (x >> 8)) & jnp.uint32(0x0000FFFF)
    return x


@jax.jit
def peq_from_packed(qwords: jax.Array, qlens: jax.Array) -> jax.Array:
    """Per-code query bitmasks from packed words: u32[B, Wq] -> u32[B, 4, NB].

    Bit ``i`` of ``Peq[b, c, i // 32]`` (at position ``i % 32``) is set iff
    query ``b``'s nucleotide ``i`` has 2-bit code ``c``.  Bits at and beyond
    ``qlens[b]`` are zero in every plane (the packed stream's 'A' padding
    must not match text 'A's).  ``NB = ceil(Wq / 2)`` blocks of 32 rows.
    """
    B, wq = qwords.shape
    if wq % 2:  # pad to a whole 32-row block; padding is masked out below
        qwords = jnp.concatenate(
            [qwords, jnp.zeros((B, 1), jnp.uint32)], axis=1
        )
        wq += 1
    nb = wq // 2
    planes = []
    for c in range(4):
        rep = jnp.uint32(c * 0x55555555)  # code c in every 2-bit field
        same = ~(qwords ^ rep)
        both = same & (same >> 1) & jnp.uint32(0x55555555)
        m16 = _compress_even_bits(both)  # low 16 bits: per-nt match flags
        blocks = m16[:, 0::2] | (m16[:, 1::2] << 16)  # (B, NB)
        planes.append(blocks)
    peq = jnp.stack(planes, axis=1)  # (B, 4, NB)
    # zero rows >= qlen: block b keeps min(max(qlen - 32*b, 0), 32) low bits
    bits = jnp.clip(
        qlens.astype(jnp.int32)[:, None]
        - ROWS_PER_BLOCK * jnp.arange(nb, dtype=jnp.int32)[None, :],
        0,
        ROWS_PER_BLOCK,
    )
    shift = jnp.minimum(bits, 31).astype(jnp.uint32)
    mask = jnp.where(bits >= 32, _FULL, (_U1 << shift) - _U1)
    return peq & mask[:, None, :]


#: query bytes allowed by :func:`peq_from_bytes` (N/n match any base)
_QUERY_OK = frozenset(b"ACGTUacgtuNn")


def peq_from_bytes(query: bytes) -> tuple[np.ndarray, int]:
    """ASCII query -> (``Peq`` u32[4, NB], m); ``N``/``n`` matches any base.

    Host-side compiler for the query-vs-records use (CLI ``approx``): a
    wildcard sets its row's bit in all four planes, which the packed-word
    builder (:func:`peq_from_packed`) cannot express.  Rejects bytes
    outside ``{A,C,G,T,U,N}`` (either case) — a typo'd query would
    otherwise silently align as its ``(byte >> 1) & 3`` alias.
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
    nb = -(-m // ROWS_PER_BLOCK)
    peq = np.zeros((4, nb), np.uint32)
    for i, b in enumerate(query):
        blk, bit = divmod(i, ROWS_PER_BLOCK)
        if b in b"Nn":
            peq[:, blk] |= np.uint32(1 << bit)
        else:
            peq[(b >> 1) & 3, blk] |= np.uint32(1 << bit)
    return peq, m


#: query bytes allowed by :func:`peq_from_bytes_b5` (N literal, ? = any)
_QUERY_OK_B5 = frozenset(b"ACGTUNacgtun?")


def peq_from_bytes_b5(query: bytes) -> tuple[np.ndarray, int]:
    """ASCII query -> (``Peq`` u32[5, NB], m) over base-5 DIGITS.

    ``N`` is a *literal* (the codec has a real N digit) and ``?`` the
    wildcard — the same convention as :mod:`.search`'s base-5 scanner.
    """
    if isinstance(query, str):
        query = query.encode()
    m = len(query)
    if m == 0:
        raise ValueError("empty query")
    bad = set(query) - _QUERY_OK_B5
    if bad:
        raise ValueError(
            f"query contains non-ACGTUN? bytes: {sorted(chr(b) for b in bad)}"
        )
    nb = -(-m // ROWS_PER_BLOCK)
    peq = np.zeros((5, nb), np.uint32)
    for i, b in enumerate(query):
        blk, bit = divmod(i, ROWS_PER_BLOCK)
        if b == ord("?"):
            peq[:, blk] |= np.uint32(1 << bit)
        else:
            peq[spec.BYTE_LUT_B5[b], blk] |= np.uint32(1 << bit)
    return peq, m


@functools.partial(jax.jit, static_argnames=("unroll",))
def best_match_peq_b5(
    peq: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    *,
    unroll: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """:func:`best_match_packed_b5` from precomputed 5-plane ``Peq``
    (``peq u32[B, 5, NB]``, e.g. :func:`peq_from_bytes_b5` broadcast)."""
    _, best, best_end, _ = _myers_scan_words_b5(
        peq, qlens, twords, tlens, semiglobal=True, unroll=unroll
    )
    best = jnp.where(qlens == 0, 0, best)
    best_end = jnp.where(qlens == 0, 0, best_end)
    return best, best_end


@functools.partial(jax.jit, static_argnames=("unroll",))
def best_match_peq(
    peq: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    *,
    unroll: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """:func:`best_match_packed` from precomputed ``Peq`` planes.

    ``peq u32[B, 4, NB]`` — e.g. one :func:`peq_from_bytes` result
    broadcast across the batch (which also enables N-wildcard queries).
    """
    _, best, best_end, _ = _myers_scan_words(
        peq, qlens, twords, tlens, semiglobal=True, unroll=unroll
    )
    best = jnp.where(qlens == 0, 0, best)
    best_end = jnp.where(qlens == 0, 0, best_end)
    return best, best_end


def _scan_setup(peq, qlens, semiglobal, emit_scores, tlens, track_best):
    """Shared pieces of the word-native scans: initial carry + the
    per-char DP column update (closure over the Peq planes).

    The char step is the exact wide-word emulation of Hyyro's recurrence
    (see the module docstring); both word drivers unroll it over the
    chars a packed word carries, so the ``lax.scan`` iterates words — no
    unpacked codes array ever hits HBM and the loop count drops 16x
    (2-bit) / 27x (base-5).
    """
    B, A, nb = peq.shape
    m1 = jnp.maximum(qlens.astype(jnp.int32), 1) - 1
    hb = m1 // ROWS_PER_BLOCK  # (B,) block holding the last query row
    hbit = (m1 % ROWS_PER_BLOCK).astype(jnp.uint32)
    peq_c = tuple(peq[:, c, :] for c in range(A))  # (B, NB) per code

    pv0 = tuple(jnp.full((B,), _FULL) for _ in range(nb))
    mv0 = tuple(jnp.zeros((B,), jnp.uint32) for _ in range(nb))
    score0 = qlens.astype(jnp.int32)
    carry0 = (pv0, mv0, score0, score0, jnp.zeros((B,), jnp.int32))

    def char_step(state, c, j):
        """One DP column: text code ``c`` (B,), position ``j`` (scalar)."""
        pv, mv, score, best, best_end = state
        valid = j < tlens
        # Eq per block: A-way select on the text code (cheaper than gather)
        eq = [peq_c[0][:, b] for b in range(nb)]
        for k in range(1, A):
            sel = c == k
            for b in range(nb):
                eq[b] = jnp.where(sel, peq_c[k][:, b], eq[b])
        xv, ph, mh = [], [], []
        cin = jnp.zeros((B,), jnp.uint32)
        for b in range(nb):
            e, p, m = eq[b], pv[b], mv[b]
            xv.append(e | m)
            a = e & p
            s = a + p + cin
            cin = ((s < a) | ((s == a) & (cin > 0))).astype(jnp.uint32)
            xh = (s ^ p) | e
            ph.append(m | ~(xh | p))
            mh.append(p & xh)
        # score delta from the last query row's horizontal deltas
        dp = jnp.zeros((B,), jnp.int32)
        dm = jnp.zeros((B,), jnp.int32)
        for b in range(nb):
            at = hb == b
            dp += jnp.where(at, (ph[b] >> hbit) & 1, 0).astype(jnp.int32)
            dm += jnp.where(at, (mh[b] >> hbit) & 1, 0).astype(jnp.int32)
        new_score = score + dp - dm
        # shift phase: row 0's horizontal input is +1 (global: D[0][j] = j)
        # or 0 (semiglobal: D[0][j] = 0); blocks pass their top bit upward
        phin = (
            jnp.zeros((B,), jnp.uint32)
            if semiglobal
            else jnp.ones((B,), jnp.uint32)
        )
        mhin = jnp.zeros((B,), jnp.uint32)
        new_pv, new_mv = [], []
        for b in range(nb):
            ps = (ph[b] << 1) | phin
            ms = (mh[b] << 1) | mhin
            phin = ph[b] >> 31
            mhin = mh[b] >> 31
            new_pv.append(ms | ~(xv[b] | ps))
            new_mv.append(ps & xv[b])
        # freeze state at each row's own text length
        pv = tuple(
            jnp.where(valid, npv, opv) for npv, opv in zip(new_pv, pv)
        )
        mv = tuple(
            jnp.where(valid, nmv, omv) for nmv, omv in zip(new_mv, mv)
        )
        score = jnp.where(valid, new_score, score)
        if track_best:  # min over end positions (semiglobal/prefix modes)
            better = valid & (score < best)
            best = jnp.where(better, score, best)
            best_end = jnp.where(better, j + 1, best_end)
        ys = (
            jnp.where(valid, score, jnp.int32(0x7FFFFFFF))
            if emit_scores
            else None
        )
        return (pv, mv, score, best, best_end), ys

    return carry0, char_step


def _myers_scan_words(
    peq: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    *,
    semiglobal: bool,
    unroll: int,
    emit_scores: bool = False,
    track_best: bool = True,
):
    """Myers column scan over PACKED 2-bit text words ``u32[B, Wt]``.

    The scan iterates words; each step advances 16 DP columns from one
    u32 per pair (two vector ops per char to expose the code — cheaper than
    materializing a 16x-larger codes array in HBM).  Returns
    ``(score, best, best_end, scores)``: the frozen-at-``tlen`` score,
    the running minimum over end positions with the first end achieving
    it, and (when ``emit_scores``) per-position frozen scores
    ``i32[16*Wt, B]`` (invalid steps hold ``0x7FFFFFFF``), else ``None``.
    ``semiglobal`` sets the row-0 horizontal boundary: ``D[0][j] = 0``
    (occurrence anywhere) vs ``D[0][j] = j`` (global/prefix — the running
    minimum is then the best-text-PREFIX distance, edlib's SHW).
    """
    carry0, char_step = _scan_setup(
        peq, qlens, semiglobal, emit_scores, tlens, track_best
    )
    Wt = twords.shape[1]

    def step(carry, xs):
        w, wi = xs  # (B,) u32 word, scalar word index
        j0 = spec.NT_PER_U32_2BIT * wi
        ys16 = []
        for s in range(spec.NT_PER_U32_2BIT):
            c = (w >> jnp.uint32(2 * s)) & jnp.uint32(3)
            carry, ys = char_step(carry, c, j0 + s)
            if emit_scores:
                ys16.append(ys)
        return carry, (jnp.stack(ys16) if emit_scores else None)

    xs = (twords.T, jnp.arange(Wt, dtype=jnp.int32))
    (pv, mv, score, best, best_end), scores = jax.lax.scan(
        step, carry0, xs, unroll=unroll
    )
    if emit_scores:
        scores = scores.reshape(-1, twords.shape[0])
    return score, best, best_end, scores


def _myers_scan_words_b5(
    peq: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    *,
    semiglobal: bool,
    unroll: int,
    track_best: bool = True,
):
    """Myers column scan over PACKED base-5 text: ``u32[B, 2*W]`` pairs.

    Each step splits one u32 pair into 9 triplets (the decode tier's
    layout) and 27 digits via exact multiply-shifts, advancing 27 DP
    columns per scan iteration.
    """
    carry0, char_step = _scan_setup(
        peq, qlens, semiglobal, False, tlens, track_best
    )
    B, w2 = twords.shape
    if w2 % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    pair = twords.reshape(B, w2 // 2, 2)
    lo_t, hi_t = pair[..., 0].T, pair[..., 1].T  # (W, B)
    m7 = jnp.uint32(0x7F)

    def step(carry, xs):
        lo, hi, wi = xs
        trips = (
            lo & m7,
            (lo >> 7) & m7,
            (lo >> 14) & m7,
            (lo >> 21) & m7,
            ((lo >> 28) | (hi << 4)) & m7,
            (hi >> 3) & m7,
            (hi >> 10) & m7,
            (hi >> 17) & m7,
            (hi >> 24) & m7,
        )
        j0 = spec.NT_PER_WORD_B5 * wi
        for k, t in enumerate(trips):
            q5 = (t * jnp.uint32(205)) >> 10  # t // 5, exact for t < 1024
            q25 = (t * jnp.uint32(41)) >> 10  # t // 25
            for r, d in enumerate((t - 5 * q5, q5 - 5 * q25, q25)):
                carry, _ = char_step(carry, d, j0 + 3 * k + r)
        return carry, None

    xs = (lo_t, hi_t, jnp.arange(lo_t.shape[0], dtype=jnp.int32))
    (pv, mv, score, best, best_end), _ = jax.lax.scan(
        step, carry0, xs, unroll=unroll
    )
    return score, best, best_end, None


@functools.partial(jax.jit, static_argnames=("unroll",))
def edit_distance_packed(
    qwords: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    *,
    unroll: int = 1,
) -> jax.Array:
    """Batched global Levenshtein distance, packed-in: ``-> i32[B]``.

    ``qwords u32[B, Wq]`` / ``twords u32[B, Wt]`` are 2-bit packed streams
    ('A'-padded past ``qlens`` / ``tlens``, as the codecs emit); rows are
    independent pairs.  Each text step advances all ``B`` pairs' DP columns
    at once; queries up to ``16 * Wq`` nt, texts up to ``16 * Wt`` nt,
    ragged lengths handled per row.
    """
    peq = peq_from_packed(qwords, qlens)
    score, _, _, _ = _myers_scan_words(
        peq, qlens, twords, tlens, semiglobal=False, unroll=unroll,
        track_best=False,
    )
    # m == 0: every text char is an insertion; n == 0 is already score == m
    return jnp.where(qlens == 0, tlens.astype(jnp.int32), score)


@functools.partial(jax.jit, static_argnames=("unroll",))
def best_match_packed(
    qwords: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    *,
    unroll: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Best approximate occurrence of each query in its text.

    Semiglobal alignment (text prefix/suffix free): returns
    ``(dist i32[B], end i32[B])`` — the minimum edit distance between the
    full query and any substring of the text, and the end position (number
    of text chars consumed) of the first substring achieving it.  ``end``
    is 0 when the empty substring is best (``dist == qlen``).
    """
    peq = peq_from_packed(qwords, qlens)
    _, best, best_end, _ = _myers_scan_words(
        peq, qlens, twords, tlens, semiglobal=True, unroll=unroll
    )
    best = jnp.where(qlens == 0, 0, best)
    best_end = jnp.where(qlens == 0, 0, best_end)
    return best, best_end


@functools.partial(jax.jit, static_argnames=("unroll",))
def prefix_distance_packed(
    qwords: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    *,
    unroll: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Whole query vs the best text PREFIX (edlib's SHW mode).

    The third anchoring of the same scan: global keeps ``D[0][j] = j``
    and reads the final score, semiglobal frees both text ends, this mode
    frees only the text *suffix* — the running minimum of the global-mode
    scan.  Returns ``(dist i32[B], end i32[B])``; ``end == 0`` means the
    empty prefix (all-deletions) is best.  Adapter/primer trimming is the
    canonical use: "how much of the read's head does this query explain".
    """
    peq = peq_from_packed(qwords, qlens)
    _, best, best_end, _ = _myers_scan_words(
        peq, qlens, twords, tlens, semiglobal=False, unroll=unroll
    )
    best = jnp.where(qlens == 0, 0, best)
    best_end = jnp.where(qlens == 0, 0, best_end)
    return best, best_end


@functools.partial(jax.jit, static_argnames=("unroll",))
def match_ends_packed(
    qwords: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    max_errors: jax.Array,
    *,
    unroll: int = 1,
) -> jax.Array:
    """EVERY end position within ``max_errors`` edits: bool[B, 16 * Wt].

    The thresholded counterpart of :func:`best_match_packed` (the
    approximate analogue of ``search.match_mask``): ``out[b, j]`` is True
    iff some substring of text ``b`` ending at ``j + 1`` matches query
    ``b`` within ``max_errors[b]`` edits.  Columns cover the words' full
    16 * Wt capacity; positions at and past ``tlens[b]`` are False.
    """
    peq = peq_from_packed(qwords, qlens)
    _, _, _, scores = _myers_scan_words(
        peq, qlens, twords, tlens, semiglobal=True, unroll=unroll,
        emit_scores=True,
    )
    return _ends_mask(scores, max_errors, tlens)


def _ends_mask(scores, max_errors, tlens):
    """Thresholded end mask with the past-``tlens`` columns cleared
    EXPLICITLY: frozen-state columns carry an INT32_MAX score sentinel,
    which ``max_errors == INT32_MAX`` (a natural 'no limit') would
    otherwise admit, violating the documented contract (r05 review)."""
    ok = (scores <= max_errors.astype(jnp.int32)[None, :]).T
    pos = jax.lax.broadcasted_iota(jnp.int32, ok.shape, 1)
    return ok & (pos < tlens.astype(jnp.int32)[:, None])


@functools.partial(jax.jit, static_argnames=("unroll",))
def match_ends_peq(
    peq: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    max_errors: jax.Array,
    *,
    unroll: int = 1,
) -> jax.Array:
    """:func:`match_ends_packed` from precomputed ``Peq`` planes
    (``u32[B, 4, NB]`` — the query-vs-records form, N wildcards ok)."""
    _, _, _, scores = _myers_scan_words(
        peq, qlens, twords, tlens, semiglobal=True, unroll=unroll,
        emit_scores=True,
    )
    return _ends_mask(scores, max_errors, tlens)


def _unpack_digits_b5_t(twords: jax.Array) -> jax.Array:
    """Packed base-5 text u32[B, 2*W] -> time-major digits u8[27*W, B].

    Triplet extraction + exact multiply-shift splits, the decode tier's
    digit path (ops/xla.py decode_b5_bytes) stopped at digits.
    """
    B, w2 = twords.shape
    if w2 % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    pair = twords.reshape(B, w2 // 2, 2)
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
    )  # (B, W, 9) triplets in [0, 125)
    q5 = (t * jnp.uint32(205)) >> 10  # t // 5, exact for t < 1024
    q25 = (t * jnp.uint32(41)) >> 10  # t // 25
    d = jnp.stack([t - 5 * q5, q5 - 5 * q25, q25], axis=-1)
    return d.reshape(B, -1).astype(jnp.uint8).T


def _peq_from_codes(
    codes: jax.Array, qlens: jax.Array, alphabet: int
) -> jax.Array:
    """Integer codes u8/i32[B, L] -> ``Peq`` u32[B, alphabet, NB]."""
    B, L = codes.shape
    nb = max(1, -(-L // ROWS_PER_BLOCK))
    pad = ROWS_PER_BLOCK * nb - L
    if pad:  # 255 matches no plane
        codes = jnp.concatenate(
            [codes, jnp.full((B, pad), 255, codes.dtype)], axis=1
        )
    grid = codes.reshape(B, 1, nb, ROWS_PER_BLOCK)
    syms = jnp.arange(alphabet, dtype=codes.dtype).reshape(1, alphabet, 1, 1)
    weights = (_U1 << jnp.arange(ROWS_PER_BLOCK, dtype=jnp.uint32))
    peq = jnp.sum(
        (grid == syms).astype(jnp.uint32) * weights, axis=-1
    )  # (B, A, NB)
    bits = jnp.clip(
        qlens.astype(jnp.int32)[:, None]
        - ROWS_PER_BLOCK * jnp.arange(nb, dtype=jnp.int32)[None, :],
        0,
        ROWS_PER_BLOCK,
    )
    shift = jnp.minimum(bits, 31).astype(jnp.uint32)
    mask = jnp.where(bits >= 32, _FULL, (_U1 << shift) - _U1)
    return peq & mask[:, None, :]


@functools.partial(jax.jit, static_argnames=("unroll",))
def edit_distance_packed_b5(
    qwords: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    *,
    unroll: int = 1,
) -> jax.Array:
    """Batched global Levenshtein on base-5 packed streams: ``-> i32[B]``.

    The base-5 mirror of :func:`edit_distance_packed`: distances over the
    FIVE-symbol alphabet — ``N`` is a literal digit (matches ``N``,
    mismatches everything else), the codec's semantics (as in
    :mod:`.search`'s base-5 scanner).  Streams are the u32-pair base-125
    serialization ('A'-padded past the lengths).
    """
    qd = _unpack_digits_b5_t(qwords).T  # (B, Lq) digits
    peq = _peq_from_codes(qd, qlens, 5)
    score, _, _, _ = _myers_scan_words_b5(
        peq, qlens, twords, tlens, semiglobal=False, unroll=unroll,
        track_best=False,
    )
    return jnp.where(qlens == 0, tlens.astype(jnp.int32), score)


@functools.partial(jax.jit, static_argnames=("unroll",))
def best_match_packed_b5(
    qwords: jax.Array,
    qlens: jax.Array,
    twords: jax.Array,
    tlens: jax.Array,
    *,
    unroll: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Base-5 mirror of :func:`best_match_packed` (5-symbol alphabet,
    ``N`` literal): ``(dist i32[B], end i32[B])``."""
    qd = _unpack_digits_b5_t(qwords).T
    peq = _peq_from_codes(qd, qlens, 5)
    _, best, best_end, _ = _myers_scan_words_b5(
        peq, qlens, twords, tlens, semiglobal=True, unroll=unroll
    )
    best = jnp.where(qlens == 0, 0, best)
    best_end = jnp.where(qlens == 0, 0, best_end)
    return best, best_end


def halo_words(m: int) -> int:
    """u32 words covering the ``2m - 2`` nt overlap any occurrence
    strictly better than the trivial distance ``m`` can need: semiglobal
    distance satisfies ``d >= |span - m|``, so ``d < m`` implies
    ``span <= 2m - 1`` — a row/shard that owns an occurrence's start plus
    this halo contains it entirely."""
    return max(1, -(-(2 * m - 2) // spec.NT_PER_U32_2BIT))


def stream_rows_plan(W: int, m: int) -> tuple[int, int, int]:
    """Row-split plan for a one-stream scan: ``(R, wrb, H)``.

    Rows overlapping by :func:`halo_words` collectively see every
    occurrence worth reporting — the strictly-sequential scan then runs
    lane-parallel over ``R`` rows of ``wrb`` base words (+ ``H`` halo
    words) each.  ``R`` is sized so the re-scanned halo is ~25% of the
    stream, capped at 32768 rows (fewer, longer rows leave the scan
    bound by its sequential step count).
    """
    H = halo_words(m)
    R = max(1, min(32768, (2 * W) // max(m - 1, 1), W))
    wrb = -(-W // R)
    return -(-W // wrb), wrb, H


def _overlap_rows(flat: jax.Array, R: int, wrb: int, H: int) -> jax.Array:
    """Overlapping row panels u32[R, wrb + H] of a flat stream WITHOUT a
    gather: row ``r`` = ``flat[r*wrb : r*wrb + wrb + H]``, zeros beyond
    the stream (the scan freezes past ``tlens``, so pad content is never
    scored).  An earlier ``jnp.take`` index-grid form spent most of the
    approx-stream scan's device time in that one gather."""
    Wt = flat.shape[0]
    pad = R * wrb - Wt
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros(pad, flat.dtype)])
    b = flat.reshape(R, wrb)
    parts = [b]
    h, k = H, 1
    while h > 0:  # halo wider than a row spans successive successors
        take = min(wrb, h)
        # the k-th successor may not exist at all (halo spanning more
        # rows than the panel has, e.g. a long query on a short stream):
        # the zero block must then carry ALL R rows, not k (r05 review,
        # reproduced as a trace-time concatenate error)
        parts.append(
            jnp.concatenate(
                [b[k:, :take], jnp.zeros((min(k, R), take), flat.dtype)],
                axis=0,
            )
        )
        h -= take
        k += 1
    return jnp.concatenate(parts, axis=1)


@functools.partial(jax.jit, static_argnames=("m", "plan", "unroll"))
def _best_match_stream_impl(
    peq: jax.Array,
    ext: jax.Array,
    length: jax.Array,
    m: int,
    plan: tuple[int, int, int],
    unroll: int = 1,
):
    R, wrb, H = plan
    rows = _overlap_rows(ext, R, wrb, H)
    base = spec.NT_PER_U32_2BIT * wrb * jnp.arange(R, dtype=jnp.int32)
    tl = jnp.clip(
        length - base, 0, spec.NT_PER_U32_2BIT * (wrb + H)
    ).astype(jnp.int32)
    d, e = best_match_peq(
        jnp.broadcast_to(peq[None], (R,) + peq.shape),
        jnp.full((R,), m, jnp.int32),
        rows,
        tl,
        unroll=unroll,
    )
    dmin = jnp.min(d)
    emin = jnp.min(
        jnp.where(d == dmin, base + e, jnp.int32(0x7FFFFFFF))
    )
    return dmin, jnp.where(dmin >= m, 0, emin)


def best_match_stream(
    words, length: int, query: bytes, *, unroll: int = 1
) -> tuple[int, int]:
    """Best approximate occurrence of ``query`` in ONE long packed stream.

    ``words u32[W]`` (the serialized 2-bit stream), ``length`` its
    nucleotide count.  The stream splits into overlapping rows per
    :func:`stream_rows_plan`, so the text-sequential DP runs across vector
    lanes; ``N``/``n`` in the query matches any base.  Returns
    ``(dist, end)`` — the minimum edit distance of the full query against
    any substring, and the first end position achieving it (``(m, 0)``
    when nothing beats the empty-substring alignment).
    """
    peq, m = peq_from_bytes(query)
    words = jnp.asarray(words)
    if words.ndim != 1:
        raise ValueError("best_match_stream takes a 1-D u32 word stream")
    if length > spec.NT_PER_U32_2BIT * words.shape[0]:
        raise ValueError("length exceeds stream capacity")
    if length >= 2**31:
        raise ValueError(
            "single-device scan positions are int32; shard streams "
            ">= 2^31 nt with parallel.longseq.best_match_long"
        )
    if length == 0 or words.shape[0] == 0:
        return m, 0  # empty text: only the trivial alignment exists
    plan = stream_rows_plan(words.shape[0], m)
    d, e = _best_match_stream_impl(
        jnp.asarray(peq), words, jnp.int32(length), m, plan, unroll=unroll
    )
    return int(d), int(e)


def stream_rows_plan_b5(Wp: int, m: int) -> tuple[int, int, int]:
    """Base-5 row-split plan over u32 PAIRS (27 nt each): ``(R, prb, Hp)``.

    Same span-bound construction as :func:`stream_rows_plan`, but row
    boundaries land on pair (triplet-block) boundaries.
    """
    Hp = max(1, -(-(2 * m - 2) // spec.NT_PER_WORD_B5))
    R = max(1, min(32768, (3 * Wp) // max(m - 1, 1), Wp))
    prb = -(-Wp // R)
    return -(-Wp // prb), prb, Hp


@functools.partial(jax.jit, static_argnames=("m", "plan", "unroll"))
def _best_match_stream_impl_b5(
    peq: jax.Array,
    ext: jax.Array,
    length: jax.Array,
    m: int,
    plan: tuple[int, int, int],
    unroll: int = 1,
):
    R, prb, Hp = plan
    # pair boundaries are u32-even, so the flat stream splits contiguously:
    # row r = ext[2*prb*r : 2*prb*r + 2*(prb + Hp)] — same gather-free
    # panel build as the 2-bit scan
    rows = _overlap_rows(ext, R, 2 * prb, 2 * Hp)
    base = spec.NT_PER_WORD_B5 * prb * jnp.arange(R, dtype=jnp.int32)
    tl = jnp.clip(
        length - base, 0, spec.NT_PER_WORD_B5 * (prb + Hp)
    ).astype(jnp.int32)
    d, e = best_match_peq_b5(
        jnp.broadcast_to(peq[None], (R,) + peq.shape),
        jnp.full((R,), m, jnp.int32),
        rows,
        tl,
        unroll=unroll,
    )
    dmin = jnp.min(d)
    emin = jnp.min(jnp.where(d == dmin, base + e, jnp.int32(0x7FFFFFFF)))
    return dmin, jnp.where(dmin >= m, 0, emin)


def best_match_stream_b5(
    words, length: int, query: bytes, *, unroll: int = 1
) -> tuple[int, int]:
    """Base-5 mirror of :func:`best_match_stream` (one long packed stream,
    digit alphabet — ``N`` literal, ``?`` wildcard).  ``words u32[2*Wp]``
    is the serialized base-5 stream; returns ``(dist, end)``."""
    peq, m = peq_from_bytes_b5(query)
    words = jnp.asarray(words)
    if words.ndim != 1 or words.shape[0] % 2:
        raise ValueError(
            "best_match_stream_b5 takes a flat u32 stream of whole pairs"
        )
    if length > spec.NT_PER_WORD_B5 * (words.shape[0] // 2):
        raise ValueError("length exceeds stream capacity")
    if length >= 2**31:
        raise ValueError("single-device scan positions are int32")
    if length == 0 or words.shape[0] == 0:
        return m, 0  # empty text: only the trivial alignment exists
    plan = stream_rows_plan_b5(words.shape[0] // 2, m)
    d, e = _best_match_stream_impl_b5(
        jnp.asarray(peq), words, jnp.int32(length), m, plan, unroll=unroll
    )
    return int(d), int(e)


def _fold_codes(seq: bytes) -> np.ndarray:
    return (np.frombuffer(bytes(seq), np.uint8) >> 1) & 3


def _wild_rows(seq: bytes) -> np.ndarray:
    """Per-position wildcard flags: ``N``/``n`` matches any base for free
    (the device Peq wildcard semantics — all oracles must agree)."""
    return (np.frombuffer(bytes(seq), np.uint8) & 0xDF) == ord("N")


def _dp_last_row(ca, cb, wild) -> np.ndarray:
    """Global-recurrence DP over integer codes: the last row ``D[m][:]``
    (``D[0][j] = j``).  Shared by the global, prefix and native-fallback
    oracles; ``wild[i]`` makes query row ``i`` match any code for free."""
    prev = np.arange(len(cb) + 1, dtype=np.int64)
    for i, x in enumerate(ca):
        cur = np.empty_like(prev)
        cur[0] = prev[0] + 1
        cur[1:] = np.minimum(prev[:-1] + ((cb != x) & ~wild[i]), prev[1:] + 1)
        for j in range(1, len(cur)):  # left-to-right insertion chain
            cur[j] = min(cur[j], cur[j - 1] + 1)
        prev = cur
    return prev


def _dp_best_match(cq, ct, wild) -> tuple[int, int]:
    """Semiglobal DP over integer codes: ``(min dist, first best end)``
    (``D[0][j] = 0``)."""
    m = len(cq)
    prev = np.arange(m + 1, dtype=np.int64)  # D[i][0] = i
    best, best_end = m, 0
    for j, x in enumerate(ct):
        cur = np.empty_like(prev)
        cur[0] = 0  # D[0][j] = 0: text prefix free
        for i in range(1, m + 1):
            cur[i] = min(
                prev[i - 1] + int(cq[i - 1] != x and not wild[i - 1]),
                prev[i] + 1,
                cur[i - 1] + 1,
            )
        prev = cur
        if cur[m] < best:
            best, best_end = int(cur[m]), j + 1
    return best, best_end


def edit_distance_reference(a: bytes, b: bytes) -> int:
    """NumPy DP oracle: global Levenshtein over normalized codes
    (``N``/``n`` in ``a``, the query, matches any base)."""
    return int(_dp_last_row(_fold_codes(a), _fold_codes(b), _wild_rows(a))[-1])


def prefix_distance_reference(q: bytes, t: bytes) -> tuple[int, int]:
    """DP oracle for :func:`prefix_distance_packed` (SHW): the global-mode
    last row's ``(min, first argmin)`` — query vs the best text prefix."""
    row = _dp_last_row(_fold_codes(q), _fold_codes(t), _wild_rows(q))
    return int(row.min()), int(row.argmin())


def semiglobal_traceback(
    query: bytes, window: bytes
) -> tuple[int, int, int, str]:
    """Full semiglobal DP + traceback on a small window: ``(dist, start,
    end, cigar)``.

    The device scan reports only ``(dist, end)``; callers wanting aligner
    output re-run a *tiny* host DP on the window around the end (any
    occurrence beating the trivial ``m`` spans <= 2m - 1 nt, so the
    window is O(m^2) work regardless of text size).  ``start``/``end``
    are window offsets of the matched substring; the CIGAR is in SAM
    convention with the query as the read (``M`` aligned, ``I`` query
    insertion, ``D`` text base skipped), runs compressed, matches kept as
    ``M`` (not ``=``/``X``).  ``N``/``n`` in the query matches any base
    for free (the device scan's wildcard semantics — the two must agree
    or the CIGAR would contradict the reported distance).
    """
    if isinstance(query, str):
        query = query.encode()
    wild = (np.frombuffer(bytes(query), np.uint8) & 0xDF) == ord("N")
    return _traceback_core(_fold_codes(query), _fold_codes(window), wild)


def semiglobal_traceback_b5(
    query: bytes, window: bytes
) -> tuple[int, int, int, str]:
    """Base-5 mirror of :func:`semiglobal_traceback`: digit alphabet,
    ``N`` literal, ``?`` wildcard (:func:`peq_from_bytes_b5` semantics)."""
    if isinstance(query, str):
        query = query.encode()
    wild = np.frombuffer(bytes(query), np.uint8) == ord("?")
    return _traceback_core(_b5_digits_of(query), _b5_digits_of(window), wild)


def _traceback_core(
    cq: np.ndarray, ct: np.ndarray, wild: np.ndarray
) -> tuple[int, int, int, str]:
    m, n = len(cq), len(ct)
    D = np.zeros((m + 1, n + 1), np.int64)
    D[:, 0] = np.arange(m + 1)  # D[i][0] = i; D[0][j] = 0 (prefix free)
    for i in range(1, m + 1):
        sub = (ct != cq[i - 1]) & ~wild[i - 1]
        D[i, 1:] = np.minimum(D[i - 1, :-1] + sub, D[i - 1, 1:] + 1)
        for j in range(1, n + 1):  # left-to-right D-chain
            if D[i, j - 1] + 1 < D[i, j]:
                D[i, j] = D[i, j - 1] + 1
    end = int(np.argmin(D[m]))  # first best end
    dist = int(D[m, end])
    i, j, ops = m, end, []
    while i > 0:
        if j > 0 and D[i, j] == D[i - 1, j - 1] + (
            (cq[i - 1] != ct[j - 1]) and not wild[i - 1]
        ):
            ops.append("M")
            i, j = i - 1, j - 1
        elif D[i, j] == D[i - 1, j] + 1:
            ops.append("I")
            i -= 1
        else:
            ops.append("D")
            j -= 1
    ops.reverse()
    cigar, run = [], 0
    for k, op in enumerate(ops):
        run += 1
        if k + 1 == len(ops) or ops[k + 1] != op:
            cigar.append(f"{run}{op}")
            run = 0
    return dist, j, end, "".join(cigar)


def _b5_digits_of(seq: bytes) -> np.ndarray:
    from . import spec as _spec

    return _spec.BYTE_LUT_B5[np.frombuffer(bytes(seq), np.uint8)]


def edit_distance_reference_b5(a: bytes, b: bytes) -> int:
    """DP oracle over base-5 DIGITS: the 5-symbol alphabet, ``N`` a
    literal (no wildcards — the codec's semantics)."""
    ca = _b5_digits_of(a)
    return int(
        _dp_last_row(ca, _b5_digits_of(b), np.zeros(len(ca), bool))[-1]
    )


def best_match_reference_b5(q: bytes, t: bytes) -> tuple[int, int]:
    """Base-5-digit DP oracle for :func:`best_match_packed_b5`."""
    cq = _b5_digits_of(q)
    return _dp_best_match(cq, _b5_digits_of(t), np.zeros(len(cq), bool))


def best_match_reference(q: bytes, t: bytes) -> tuple[int, int]:
    """DP oracle for :func:`best_match_packed`: ``(dist, first end)``
    (``N``/``n`` in the query matches any base)."""
    return _dp_best_match(_fold_codes(q), _fold_codes(t), _wild_rows(q))
