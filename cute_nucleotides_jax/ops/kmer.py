"""K-mer extraction and counting on the 2-bit packed domain.

The point of a 2-bit codec in production is what you can do *without
decoding*; k-mers are the canonical example.  A k-mer starting at nucleotide
``i`` is simply bits ``[2i, 2i + 2k)`` of the packed stream, so extraction is
a funnel shift over adjacent u32 words — no ASCII round-trip, ~1/4 the
memory traffic of a byte-domain k-mer scan.

Two extraction forms:

* **Position-ordered** (:func:`kmer_codes`): codes in stream order via two
  ``jnp.take`` gathers; simple, order-exact, slow (index materialization).
* **Planar** (:func:`kmer_codes_planar`, used by the counters and
  sketches): whole-array funnel shifts over (row, word-lane) panels
  producing PLANAR codes (shift-plane major — a permutation of the
  position order, which a histogram doesn't care about); no gather.

Production k sizes (21/31, the standard assembly/counting choices) are
first-class: a k-mer up to k = 31 is a u32 *pair* ``(lo, hi)`` — the same
funnel shift reads one more successor word — with revcomp/canonical working
on the pair.  Counting forms:

* **Dense scatter-add** (k <= 12): ``4**k`` bins (64 MiB at k = 12 — the
  dense-array ceiling; a k = 21 dense histogram would be 17 TB).
* **Sorted-segment counts** (:func:`kmer_counts`, any k <= 31): sort the
  codes (two-key lexicographic sort for pairs) and emit per-run counts —
  the form production k-mer counters output (the *occurring* k-mers with
  multiplicities, not the impossible dense array).

Canonical form (the lexicographic minimum of a k-mer and its reverse
complement, the standard de-duplication in assembly/counting pipelines)
uses the same SWAR field-reversal tricks as :mod:`.seqops`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import spec

__all__ = [
    "kmer_codes",
    "kmer_codes_pair",
    "kmer_codes_planar",
    "kmer_codes_planar_pair",
    "revcomp_code",
    "revcomp_code_pair",
    "canonical_codes",
    "canonical_codes_pair",
    "kmer_histogram",
    "kmer_histogram_batch",
    "kmer_counts",
    "kmer_hashes",
    "minimizers",
]


@functools.partial(jax.jit, static_argnames=("length", "k"))
def kmer_codes(words: jax.Array, length: int, k: int) -> jax.Array:
    """All k-mer codes of a packed u32[W] stream: -> i32[length - k + 1].

    Code layout matches the packing: the first nucleotide of the k-mer is the
    LEAST significant 2 bits (LSB-first, like the words themselves).
    """
    if not 1 <= k <= 15:
        raise ValueError("k must be in [1, 15]")
    if words.ndim != 1:
        raise TypeError("kmer_codes takes a flat u32 word stream")
    n = length - k + 1
    if n <= 0:
        raise ValueError(f"length {length} too short for k={k}")
    if length > words.shape[0] * spec.NT_PER_U32_2BIT:
        raise ValueError("length exceeds stream capacity")
    # funnel shift: position i needs word i//16 and its successor
    padded = jnp.concatenate([words, jnp.zeros(1, jnp.uint32)])
    i = jnp.arange(n)
    wl = jnp.take(padded, i // 16)
    wh = jnp.take(padded, i // 16 + 1)
    s = (2 * (i % 16)).astype(jnp.uint32)
    window = (wl >> s) | jnp.where(s == 0, jnp.uint32(0), wh << (32 - s))
    return (window & jnp.uint32((1 << (2 * k)) - 1)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("length", "k"))
def kmer_codes_pair(
    words: jax.Array, length: int, k: int
) -> tuple[jax.Array, jax.Array]:
    """All k-mer codes for 16 <= k <= 31 as u32 pairs:
    -> (lo u32[n], hi u32[n]), n = length - k + 1.

    ``lo | hi << 32`` is the 2k-bit code with the k-mer's first nucleotide
    in the least significant 2 bits (LSB-first, like the packed words);
    the window spans up to three u32 words, so the funnel takes two
    successor taps.
    """
    if not 16 <= k <= 31:
        raise ValueError("kmer_codes_pair covers k in [16, 31]; use kmer_codes below")
    if words.ndim != 1:
        raise TypeError("kmer_codes_pair takes a flat u32 word stream")
    n = length - k + 1
    if n <= 0:
        raise ValueError(f"length {length} too short for k={k}")
    if length > words.shape[0] * spec.NT_PER_U32_2BIT:
        raise ValueError("length exceeds stream capacity")
    padded = jnp.concatenate([words, jnp.zeros(2, jnp.uint32)])
    i = jnp.arange(n)
    w0 = jnp.take(padded, i // 16)
    w1 = jnp.take(padded, i // 16 + 1)
    w2 = jnp.take(padded, i // 16 + 2)
    s = (2 * (i % 16)).astype(jnp.uint32)
    z = jnp.uint32(0)
    lo = (w0 >> s) | jnp.where(s == 0, z, w1 << (32 - s))
    hi = jnp.where(s == 0, w1, (w1 >> s) | (w2 << (32 - s)))
    return lo, hi & jnp.uint32((1 << (2 * k - 32)) - 1)


def _rev32_fields(c: jax.Array) -> jax.Array:
    """Reverse the sixteen 2-bit fields of each u32 lane (SWAR)."""
    c = ((c & jnp.uint32(0x33333333)) << 2) | ((c >> 2) & jnp.uint32(0x33333333))
    c = ((c & jnp.uint32(0x0F0F0F0F)) << 4) | ((c >> 4) & jnp.uint32(0x0F0F0F0F))
    c = ((c & jnp.uint32(0x00FF00FF)) << 8) | ((c >> 8) & jnp.uint32(0x00FF00FF))
    return (c << 16) | (c >> 16)


def revcomp_code(codes: jax.Array, k: int) -> jax.Array:
    """Reverse-complement of 2-bit k-mer codes (elementwise, SWAR):
    complement-XOR, :func:`_rev32_fields`, then shift down to k fields."""
    c = codes.astype(jnp.uint32) ^ jnp.uint32(0xAAAAAAAA >> (32 - 2 * k) if k < 16 else 0xAAAAAAAA)
    return (_rev32_fields(c) >> (32 - 2 * k)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def canonical_codes(codes: jax.Array, k: int) -> jax.Array:
    """min(code, revcomp(code)) — the canonical k-mer form."""
    return jnp.minimum(codes, revcomp_code(codes, k))


def revcomp_code_pair(
    lo: jax.Array, hi: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Reverse-complement of u32-pair k-mer codes (16 <= k <= 31).

    Complement is one XOR per plane; the 64-bit field reversal is the two
    32-bit SWAR reversals with the planes swapped; the down-shift by
    ``64 - 2k`` (which also flushes the complemented garbage fields past
    position k) is a static lane-local funnel over the pair.
    """
    if not 16 <= k <= 31:
        raise ValueError("revcomp_code_pair covers k in [16, 31]")
    aa = jnp.uint32(0xAAAAAAAA)
    rlo = _rev32_fields(hi ^ aa)  # low word of the reversed 64-bit value
    rhi = _rev32_fields(lo ^ aa)
    s = 64 - 2 * k  # in [2, 32]
    if s == 32:
        return rhi, jnp.zeros_like(rhi)
    out_lo = (rlo >> s) | (rhi << (32 - s))
    out_hi = rhi >> s
    return out_lo, out_hi


@functools.partial(jax.jit, static_argnames=("k",))
def canonical_codes_pair(
    lo: jax.Array, hi: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Lexicographic min of a pair code and its reverse complement."""
    rlo, rhi = revcomp_code_pair(lo, hi, k)
    take_rc = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    return jnp.where(take_rc, rlo, lo), jnp.where(take_rc, rhi, hi)


# --- planar extraction ------------------------------------------------------

#: word lanes per panel row of the planar layout
_PLANAR_W = 512


def _check_panels(*arrays: jax.Array) -> None:
    shape = arrays[0].shape
    if len(shape) != 2 or any(a.shape != shape for a in arrays):
        raise TypeError(
            f"expected matching u32[R, W] panels, got {[a.shape for a in arrays]}"
        )


def _funnel_planes(w: jax.Array, nx: jax.Array) -> jax.Array:
    """u32[R, W] words + successors -> u32[R, 16, W]: plane ``s`` holds the
    32-bit window starting at nucleotide ``s`` of each word."""
    sh = (2 * jnp.arange(spec.NT_PER_U32_2BIT, dtype=jnp.uint32))[None, :, None]
    lo = w[:, None, :] >> sh
    hi = jnp.where(sh == 0, jnp.uint32(0), nx[:, None, :] << (32 - sh))
    return lo | hi


def kmer_codes_planar(words: jax.Array, nxt: jax.Array, k: int) -> jax.Array:
    """Funnel-shift k-mer extraction: u32[R, W] panels -> i32[R, 16 W].

    ``nxt`` is the successor stream (``nxt[r, w]`` = the word after
    ``words[r, w]`` in stream order; one cheap shift on the packed side).
    Output is PLANAR: the code starting at nucleotide ``16 w + s`` of row
    ``r`` lands at column ``W s + w`` — a fixed permutation of position
    order (use :func:`kmer_codes` when order matters).
    """
    _check_panels(words, nxt)
    R, W = words.shape
    codes = _funnel_planes(words, nxt) & jnp.uint32((1 << (2 * k)) - 1)
    return codes.astype(jnp.int32).reshape(R, 16 * W)


def kmer_codes_planar_pair(
    words: jax.Array, nxt: jax.Array, nxt2: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Funnel-shift extraction for 16 <= k <= 31:
    u32[R, W] panels -> (lo u32[R, 16 W], hi u32[R, 16 W]).

    ``nxt``/``nxt2`` are the one- and two-ahead successor streams.  Output
    is PLANAR like :func:`kmer_codes_planar`: the pair for the code
    starting at nucleotide ``16 w + s`` of row ``r`` lands at column
    ``W s + w`` of both planes.
    """
    if not 16 <= k <= 31:
        raise ValueError("kmer_codes_planar_pair covers k in [16, 31]")
    _check_panels(words, nxt, nxt2)
    R, W = words.shape
    lo = _funnel_planes(words, nxt)
    hi = _funnel_planes(nxt, nxt2) & jnp.uint32((1 << (2 * k - 32)) - 1)
    return lo.reshape(R, 16 * W), hi.reshape(R, 16 * W)


def _planar_panels(words: jax.Array, ahead: int) -> list[jax.Array]:
    """Flat stream -> ``[base, nxt, (nxt2)]`` (rows, _PLANAR_W) panels,
    zero-padded past the stream end."""
    flat = words.reshape(-1)
    Wtot = flat.shape[0]
    rows = -(-Wtot // _PLANAR_W)
    pad = rows * _PLANAR_W + ahead - Wtot
    padded = jnp.concatenate([flat, jnp.zeros(pad, jnp.uint32)])
    return [
        padded[a : a + rows * _PLANAR_W].reshape(rows, _PLANAR_W)
        for a in range(ahead + 1)
    ]


def _planar_positions(shape) -> jax.Array:
    """Stream position of each planar slot: col W*s + w of row r holds the
    k-mer starting at nucleotide 16*(r*W + w) + s."""
    W = _PLANAR_W
    col = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    row = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    return 16 * (row * W + col % W) + col // W


@functools.partial(jax.jit, static_argnames=("length", "k", "canonical"))
def kmer_hashes_planar(
    words: jax.Array, length: int, k: int, *, canonical: bool = True
) -> jax.Array:
    """Planar-order canonical k-mer hashes of a packed stream:
    -> u32[16 * ceil(W / 512) * 512], any k <= 31.

    Same multiset of hashes as :func:`kmer_hashes` but in the planar
    layout (NOT position order), with invalid entries — positions past
    ``length - k`` and reshape padding — set to ``0xFFFFFFFF`` (the sketch
    SENTINEL).  One deliberate conflation: fmix32 is a bijection, so
    exactly one k-mer code per plane genuinely hashes to 0xFFFFFFFF and is
    then indistinguishable from padding — sketch consumers drop it (the
    maximal hash no bottom-s estimator would select; the bias is
    documented in :mod:`.sketch`'s module docstring), while the
    position-ordered :func:`kmer_hashes` reports it as a real hash.  For
    order-free consumers (bottom-k / FracMinHash sketches, counting) this
    replaces three full-stream gathers with whole-array funnel shifts;
    position-aware consumers keep :func:`kmer_hashes`.
    """
    if not 1 <= k <= 31:
        raise ValueError("k must be in [1, 31]")
    n_valid = length - k + 1
    if n_valid <= 0:
        raise ValueError(f"length {length} too short for k={k}")
    if length > words.size * spec.NT_PER_U32_2BIT:
        raise ValueError("length exceeds stream capacity")
    if k <= 15:
        codes = kmer_codes_planar(*_planar_panels(words, 1), k)
        if canonical:
            codes = canonical_codes(codes, k)
        h = _mix32(codes.astype(jnp.uint32))
    else:
        lo, hi = kmer_codes_planar_pair(*_planar_panels(words, 2), k)
        if canonical:
            lo, hi = canonical_codes_pair(lo, hi, k)
        h = _mix32(lo ^ _mix32(hi))
    valid = _planar_positions(h.shape) < n_valid
    return jnp.where(valid, h, jnp.uint32(0xFFFFFFFF)).reshape(-1)


@functools.partial(jax.jit, static_argnames=("length", "k", "canonical"))
def _kmer_histogram_scatter(
    words: jax.Array, length: int, k: int, *, canonical: bool = False
) -> jax.Array:
    codes = kmer_codes(words, length, k)
    if canonical:
        codes = canonical_codes(codes, k)
    return jnp.zeros(4**k, jnp.int32).at[codes].add(1)


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def kmer_histogram_batch(
    words: jax.Array, lengths, k: int, *, canonical: bool = False
) -> jax.Array:
    """Summed per-read k-mer spectrum of a padded batch:
    u32[B, W] + lengths i32[B] -> i32[4**k].

    Each row is an independent read (the form the streaming pipeline
    produces, 'A'-padded to a uniform width): the per-row successor stream
    is zeroed at the row end so k-mer windows never span a read boundary
    (flattening the batch would count (B-1)(k-1) phantom junction k-mers),
    and ``lengths`` (scalar or per-read) masks both the padding tail and
    rows shorter than k.  One planar-extraction pass + one scatter-add
    histogram over the whole batch — the vectorized replacement for a
    per-read host loop.
    """
    if not 1 <= k <= 12:
        raise ValueError(
            "kmer_histogram_batch covers k in [1, 12] (dense bins); use "
            "kmer_counts per read for larger k"
        )
    if words.ndim != 2:
        raise TypeError(f"expected u32[B, W] batch, got {words.shape}")
    B, Wr = words.shape
    lengths = jnp.broadcast_to(
        jnp.asarray(lengths, jnp.int32).reshape(-1), (B,)
    )
    lengths = jnp.minimum(lengths, Wr * spec.NT_PER_U32_2BIT)
    nxt = jnp.concatenate(
        [words[:, 1:], jnp.zeros((B, 1), jnp.uint32)], axis=1
    )
    flat, nflat = words.reshape(-1), nxt.reshape(-1)
    Wtot = B * Wr
    rows = -(-Wtot // _PLANAR_W)
    pad = rows * _PLANAR_W - Wtot
    if pad:
        z = jnp.zeros(pad, jnp.uint32)
        flat = jnp.concatenate([flat, z])
        nflat = jnp.concatenate([nflat, z])
    shape = (rows, _PLANAR_W)
    codes = kmer_codes_planar(flat.reshape(shape), nflat.reshape(shape), k)
    if canonical:
        codes = canonical_codes(codes, k)
    # planar col W*s + w of panel row r holds the code at flat word
    # q = r*W + w, in-word shift s — i.e. read q // Wr, position
    # 16*(q % Wr) + s within it
    W = _PLANAR_W
    col = jax.lax.broadcasted_iota(jnp.int32, codes.shape, 1)
    row = jax.lax.broadcasted_iota(jnp.int32, codes.shape, 0)
    q = row * W + col % W
    pos = 16 * (q % Wr) + col // W
    lim = jnp.take(lengths, jnp.minimum(q // Wr, B - 1)) - (k - 1)
    valid = (q < Wtot) & (pos < lim)
    codes = jnp.where(valid, codes, 0)
    counts = jnp.zeros(4**k, jnp.int32).at[codes.reshape(-1)].add(1)
    # masked positions all landed in bin 0; remove them
    n_valid = jnp.sum(jnp.maximum(lengths - (k - 1), 0))
    return counts.at[0].add(n_valid - codes.size)


def kmer_histogram(
    words: jax.Array, length: int, k: int, *, canonical: bool = False
) -> jax.Array:
    """Count every k-mer of a packed stream: -> i32[4**k].

    ``canonical=True`` folds each k-mer with its reverse complement first,
    then a scatter-add fills the dense array (4 * 4**k bytes — 64 MiB at
    the k = 12 cap).
    Past that a dense histogram is physically impossible (17 TB at k = 21):
    use :func:`kmer_counts`, which returns the *occurring* k-mers with
    multiplicities — the form production counters emit.
    """
    if k > 12:
        raise ValueError(
            f"dense 4**{k} histogram would need {4 * 4**k / 2**30:.0f} GiB; "
            "use kmer_counts (sorted-segment counts) for k in [13, 31]"
        )
    return _kmer_histogram_scatter(words, length, k, canonical=canonical)


_SENTINEL = jnp.uint32(0xFFFFFFFF)


# --- minimizers -------------------------------------------------------------
# The windowed k-mer selection primitive of modern mappers/counters
# (minimap2's sketch, KMC3's signature partitioning): of each window of w
# consecutive k-mers, keep the one with the smallest HASH.  Hashing (instead
# of raw lexicographic codes) avoids the poly-A density pathology; the
# invertible finalizer below is the standard 64-bit mix used by minimap2's
# sketch (public-domain Murmur3/SplitMix-style avalanche), applied to the
# canonical code so a read and its reverse complement select the same set.


def _mix32(h: jax.Array) -> jax.Array:
    """Murmur3 fmix32: invertible avalanche on u32 lanes."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


@functools.partial(jax.jit, static_argnames=("length", "k", "canonical"))
def kmer_hashes(
    words: jax.Array, length: int, k: int, *, canonical: bool = True
) -> jax.Array:
    """Position-ordered avalanche hashes of every k-mer: -> u32[length-k+1].

    k <= 15 hashes the i32 code; 16 <= k <= 31 mixes the u32 pair
    (``mix(lo ^ mix(hi))`` — both words avalanche into every output bit).
    ``canonical=True`` (the default, and what minimizer sketches need)
    folds each k-mer with its reverse complement first.
    """
    if k <= 15:
        codes = kmer_codes(words, length, k)
        if canonical:
            codes = canonical_codes(codes, k)
        return _mix32(codes.astype(jnp.uint32))
    lo, hi = kmer_codes_pair(words, length, k)
    if canonical:
        lo, hi = canonical_codes_pair(lo, hi, k)
    return _mix32(lo ^ _mix32(hi))


def _shifted(a: jax.Array, s: int, left: bool, pad) -> jax.Array:
    """Lane-shifted view of a 1-D array: index ``i`` reads ``a[i - s]``
    (``left``) or ``a[i + s]``, with ``pad`` outside."""
    if s >= a.shape[0]:
        return jnp.full_like(a, pad)
    p = jnp.full(s, pad, a.dtype)
    return (
        jnp.concatenate([p, a[:-s]]) if left else jnp.concatenate([a[s:], p])
    )


def _windowed(a: jax.Array, r: int, op, pad, left: bool) -> jax.Array:
    """``op`` (min/max) over the window of ``r + 1`` elements ending
    (``left``) or starting at each index — log-depth doubling tree, the
    clipped edges padded with the identity ``pad``."""
    if r == 0:
        return a
    t, m = a, 1
    while 2 * m - 1 <= r:
        t = op(t, _shifted(t, m, left, pad))
        m *= 2
    off = r - (m - 1)
    if off:  # overlap-combine covers the non-power-of-two remainder
        t = op(t, _shifted(t, off, left, pad))
    return t


@functools.partial(jax.jit, static_argnames=("length", "k", "w", "canonical"))
def minimizers(
    words: jax.Array, length: int, k: int, w: int, *, canonical: bool = True
) -> tuple[jax.Array, jax.Array]:
    """(w, k)-minimizer mask over a packed stream: -> (mask bool[n], hash
    u32[n]), n = length - k + 1.

    Position ``p`` is a minimizer iff its k-mer attains the minimum hash of
    at least one of the windows of ``w`` consecutive k-mers containing it
    (minimap2's sketch definition).  Computed scan-free in two log-depth
    passes: the forward windowed min gives every window's minimum ``wm``,
    and because ``wm_j <= h_p`` for every window ``j`` containing ``p``,
    membership reduces to ``h_p == max(wm_j)`` over those windows — a
    backward windowed max.  Hash ties select all tied positions (ties are
    equal k-mers under the invertible mix, for which every occurrence is
    the same minimizer — robust-winnowing behavior).  Expected density
    ``2/(w+1)``.  Compress with ``jnp.nonzero`` host-side or feed the
    masked hashes to :func:`kmer_counts`-style sorting.
    """
    if w < 1:
        raise ValueError("window w must be >= 1")
    h = kmer_hashes(words, length, k, canonical=canonical)
    n = h.shape[0]
    if n <= w:
        # degenerate short read: one (possibly partial) window over all n
        return h == jnp.min(h), h
    r = w - 1
    # forward: wm[j] = min(h[j .. j+r]); entries past the last full window
    # start are zeroed so they can never win the backward max
    wm = _windowed(h, r, jnp.minimum, jnp.uint32(0xFFFFFFFF), left=False)
    idx = jnp.arange(n)
    wm = jnp.where(idx <= n - w, wm, 0)
    # backward: best[p] = max(wm[p-r .. p]) — the largest window minimum
    # among windows containing p
    best = _windowed(wm, r, jnp.maximum, jnp.uint32(0), left=True)
    return h == best, h


@functools.partial(jax.jit, static_argnames=("length", "k", "w", "canonical"))
def minimizer_bits(
    words: jax.Array,
    length: int,
    k: int,
    w: int,
    *,
    canonical: bool = True,
) -> jax.Array:
    """Packed (w, k)-minimizer mask: -> u32[ceil(n/16)], n = length - k + 1.

    Bit ``p % 16`` of word ``p // 16`` flags position ``p`` as a minimizer
    — the packed-domain native form of :func:`minimizers` (same selection
    rule, bit-identical membership).  Feed to
    :func:`..search.match_positions`-style popcount/nonzero consumers
    without ever materializing a per-position byte stream.
    """
    if w < 1:
        raise ValueError("window w must be >= 1")
    n = length - k + 1
    if n <= 0:
        raise ValueError(f"length {length} too short for k={k}")
    nw = -(-n // 16)
    mask, _ = minimizers(words.reshape(-1), length, k, w, canonical=canonical)
    pad16 = 16 * nw - n
    if pad16:
        mask = jnp.concatenate([mask, jnp.zeros(pad16, bool)])
    return (
        (mask.reshape(nw, 16).astype(jnp.uint32)
         << jnp.arange(16, dtype=jnp.uint32)[None, :])
        .sum(axis=1)
        .astype(jnp.uint32)
    )


@functools.partial(jax.jit, static_argnames=("length", "k", "canonical"))
def kmer_counts(
    words: jax.Array, length: int, k: int, *, canonical: bool = False
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Sorted-segment k-mer counting for any k <= 31:
    -> (lo u32[n], hi u32[n], counts i32[n]), n = padded position count.

    The device replacement for a hash-table counter: extract codes with
    the planar funnel (a histogram doesn't care about order), sort
    them (two-key lexicographic sort for u32-pair codes), and turn run
    boundaries into counts with a reverse cumulative min — all static
    shapes, no scatter.  Entry ``i`` is a distinct k-mer iff
    ``counts[i] > 0`` (run starts); other entries (run interiors and the
    out-of-range sentinel block at the end) carry count 0.  The number of
    distinct k-mers is ``(counts > 0).sum()`` and total mass
    ``counts.sum() == length - k + 1``.

    ``canonical=True`` folds each k-mer with its reverse complement before
    counting (the assembly/counting convention).
    """
    if not 1 <= k <= 31:
        raise ValueError("k must be in [1, 31]")
    n_valid = length - k + 1
    if n_valid <= 0:
        raise ValueError(f"length {length} too short for k={k}")
    if length > words.size * spec.NT_PER_U32_2BIT:
        raise ValueError("length exceeds stream capacity")
    if k <= 15:
        codes = kmer_codes_planar(*_planar_panels(words, 1), k)
        if canonical:
            codes = canonical_codes(codes, k)
        lo2d = codes.astype(jnp.uint32)
        hi2d = None
    else:
        lo2d, hi2d = kmer_codes_planar_pair(*_planar_panels(words, 2), k)
        if canonical:
            lo2d, hi2d = canonical_codes_pair(lo2d, hi2d, k)
    pos = _planar_positions(lo2d.shape)
    invalid = pos >= n_valid
    # out-of-range positions become the sentinel pair, which sorts last
    # (real hi < 2**(2k-32) <= 2**30; real lo < 2**30 when k <= 15)
    lo = jnp.where(invalid, _SENTINEL, lo2d).reshape(-1)
    if hi2d is None:
        (lo_s,) = jax.lax.sort((lo,), num_keys=1)
        hi_s = jnp.zeros_like(lo_s)
        sent = lo_s == _SENTINEL
        is_new = jnp.concatenate(
            [jnp.ones(1, bool), lo_s[1:] != lo_s[:-1]]
        )
    else:
        from . import sort as sort_lib

        hi = jnp.where(invalid, _SENTINEL, hi2d).reshape(-1)
        hi_s, lo_s = sort_lib.sort_pairs(hi, lo)
        sent = hi_s == _SENTINEL
        is_new = jnp.concatenate(
            [
                jnp.ones(1, bool),
                (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1]),
            ]
        )
    n = lo_s.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    start_pos = jnp.where(is_new, iota, n)
    suffix_min = jax.lax.cummin(start_pos, reverse=True)
    nxt_start = jnp.concatenate([suffix_min[1:], jnp.full(1, n, jnp.int32)])
    counts = jnp.where(is_new & ~sent, nxt_start - iota, 0)
    return lo_s, hi_s, counts
