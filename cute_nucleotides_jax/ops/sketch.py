"""MinHash sketching on the packed 2-bit domain (Mash / sourmash style).

Dataset-scale similarity straight from packed words: hash every canonical
k-mer (:func:`.kmer.kmer_hashes` — the packed stream is read once, ~1/4 the
bytes of an ASCII scan), keep a tiny order-statistic summary, and estimate
Jaccard / containment between datasets from the summaries alone.  The
reference stops at the codec (its README's unimplemented "equidistant
codes" idea is the only distance notion it sketches,
reference/README.md:412-418); this module supplies the standard
alignment-free comparison layer production pipelines put on top.

Two sketch schemes, both returned as a sorted ``u32[s]`` with empty slots
holding :data:`SENTINEL` (``0xFFFF_FFFF``):

* **Bottom-s MinHash** (:func:`bottom_k_sketch`): the ``s`` smallest
  *distinct* canonical k-mer hashes (Mash).  Fixed size, best for Jaccard
  between similarly-sized datasets.
* **FracMinHash** (:func:`frac_sketch`): every distinct hash below
  ``2**32 // scale`` (sourmash), stored in a fixed-capacity buffer.  The
  retained fraction adapts to dataset size, which is what makes
  *containment* between differently-sized datasets unbiased.

Sketches merge associatively (:func:`merge` — the bottom-s of the union),
so a device mesh reduces per-shard sketches to a dataset sketch with one
``all_gather`` (see :func:`..parallel.data_parallel.sketch_sharded`).

Everything is static-shape and jittable: the "hash set" is a sorted array,
dedup is a sort + neighbor-compare, membership is ``searchsorted`` — no
host-side Python sets anywhere on the hot path.  One deliberate bias: a
k-mer hashing to ``SENTINEL`` itself (one value in 2**32; reachable since
fmix32 is a bijection) is conflated with empty padding and dropped from
every sketch.  It is the *maximal* hash — no bottom-s estimator would
select it unless the sketch covered the entire hash space — so the
estimators are unaffected beyond a <=1-element undercount of ``n_kept``
at ``scale=1``.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from . import kmer, spec

__all__ = [
    "SENTINEL",
    "bottom_k_sketch",
    "bottom_k_sketch_batch",
    "frac_sketch",
    "frac_sketch_batch",
    "merge",
    "merge_many",
    "jaccard",
    "jaccard_matrix",
    "containment",
    "mash_distance",
]

SENTINEL = jnp.uint32(0xFFFFFFFF)


def _bottom_s_distinct_count(
    h: jax.Array, s: int
) -> tuple[jax.Array, jax.Array]:
    """Smallest ``s`` distinct values of ``h`` plus the exact distinct
    count: -> (sorted u32[s], i32).  Two sorts: ascending order makes
    duplicates adjacent, re-marking them SENTINEL and re-sorting compacts
    the distinct values to the front without any scatter; the count falls
    out of the same dup mask for free."""
    h = jnp.sort(h.reshape(-1))
    dup = jnp.concatenate(
        [jnp.zeros(1, bool), h[1:] == h[:-1]]
    )
    n_distinct = jnp.sum((h != SENTINEL) & ~dup).astype(jnp.int32)
    h = jnp.sort(jnp.where(dup, SENTINEL, h))
    n = h.shape[0]
    if n < s:
        h = jnp.concatenate([h, jnp.full(s - n, SENTINEL, jnp.uint32)])
    return h[:s], n_distinct


#: row width for the chunked bottom-s reduction (see _bottom_s_distinct)
_CHUNK = 8192

#: prefilter tuning (see _prefilter_plan): keep ~ALPHA*s expected entries
#: below the static cutoff; skip the prefilter when the per-128-lane
#: capacity it would need exceeds _CAP_MAX (shrink < 4x isn't worth the
#: extra pass) or the input is small enough to sort directly.
_ALPHA = 8
_CAP_MAX = 32
_PREFILTER_MIN = 1 << 17


def _prefilter_plan(n: int, expected: float) -> int | None:
    """Static per-128-lane survivor capacity for a threshold prefilter
    expecting ``expected`` surviving entries out of ``n``, or None when
    the prefilter isn't worthwhile.  Capacity is a Poisson tail bound
    (lam + 6*sqrt(lam) + 8) so a uniform-hash input essentially never
    overflows; overflow is still *detected* and falls back (exactness
    never rests on the bound)."""
    if n < _PREFILTER_MIN:
        return None
    lam = 128.0 * expected / n
    cap = int(math.ceil(lam + 6.0 * math.sqrt(lam) + 8.0))
    return cap if cap <= _CAP_MAX else None


def _compact_lt(
    h: jax.Array, c: int, cap: int
) -> tuple[jax.Array, jax.Array]:
    """Compact every entry of ``h`` strictly below ``c`` into a
    ``128/cap``-fold smaller array: -> (u32[ceil(n/128)*cap], ok bool).

    Survivors are extracted per 128-lane row by a narrow batched sort
    (survivors sort to the front, everything else is SENTINEL) — the
    static-shape compaction that replaces a scatter.  ``ok`` is True
    iff NO row held more than ``cap`` survivors, i.e. the output provably
    contains *all* entries below ``c`` (duplicates included); on False the
    caller must take the unfiltered path.
    """
    h = h.reshape(-1)
    n = h.size
    rows = -(-n // 128)
    if rows * 128 > n:
        h = jnp.concatenate(
            [h, jnp.full(rows * 128 - n, SENTINEL, jnp.uint32)]
        )
    x = h.reshape(rows, 128)
    keep = x < jnp.uint32(c)
    ok = jnp.max(jnp.sum(keep, axis=1, dtype=jnp.int32)) <= cap
    srt = jnp.sort(jnp.where(keep, x, SENTINEL), axis=-1)
    return srt[:, :cap].reshape(-1), ok


def _shrink_chunked(h: jax.Array, s: int) -> jax.Array:
    """Chunked bottom-``s``-distinct pre-reduction: shrink ``h`` to at
    most ``4 * max(_CHUNK, s)`` entries while preserving the global
    bottom-``s`` distinct set (and never inventing values).

    Exactness: any member of the global bottom-``s`` distinct set has
    fewer than ``s`` distinct values below it globally — so also within
    whatever chunk it lands in — hence it survives that chunk's own
    bottom-``s``-distinct.  Sorting C rows of m costs N·log(m) compares
    instead of the flat sort's N·log(N) (and batched row sorts schedule
    better than one giant sort); duplicates ACROSS chunks are cleaned by
    the final pass.  Within-chunk dedup cannot be skipped: a value
    duplicated thousands of times would push a later distinct value past
    position ``s`` of its chunk.
    """
    h = h.reshape(-1)
    # chunk width >= 4s guarantees each pass keeps at most ~n/4 entries
    # (C * s of C * m); with the old max(_CHUNK, s) a sketch size near or
    # above _CHUNK made ceil(n/m)*min(s, m) >= n — the loop never shrank
    # and the host hung at trace time (r05 review, reachable through
    # bottom_k_sketch/merge_many/CLI at s >= ~6600)
    m = max(_CHUNK, 4 * s)
    while h.size > 4 * m:
        C = -(-h.size // m)
        if C * m > h.size:
            h = jnp.concatenate(
                [h, jnp.full(C * m - h.size, SENTINEL, jnp.uint32)]
            )
        hc = jnp.sort(h.reshape(C, m), axis=-1)
        dup = jnp.concatenate(
            [jnp.zeros((C, 1), bool), hc[:, 1:] == hc[:, :-1]], axis=1
        )
        hc = jnp.sort(jnp.where(dup, SENTINEL, hc), axis=-1)
        h = hc[:, : min(s, m)].reshape(-1)
    return h


def _bottom_s_distinct(h: jax.Array, s: int) -> jax.Array:
    """Smallest ``s`` distinct values of ``h`` (count not needed).

    Large inputs first take a **threshold prefilter** (r05): with a
    static cutoff ``c ~= ALPHA*s/n * 2**32``, an expected ``ALPHA*s``
    entries survive ``h < c`` — the bottom-``s`` distinct set is a subset
    of the survivors whenever at least ``s`` distinct values lie below
    ``c``.  Survivors compact 128/cap-fold with one *narrow* batched row
    sort (:func:`_compact_lt`), shrinking the expensive distinct-sort by
    an order of magnitude.  Exactness is never assumed: the fast path is
    taken only when (a) no 128-lane row overflowed its capacity (all
    survivors captured) and (b) the survivors hold >= ``s`` distinct
    values (cutoff not too low — heavy k-mer duplication or a tiny
    dataset lowers the distinct yield); otherwise ``lax.cond`` falls back
    to the unfiltered chunked path, which is exact unconditionally.
    """
    h = h.reshape(-1)
    n = h.size
    cap = _prefilter_plan(n, float(_ALPHA * s))
    c = min(2**32 - 1, max(1, math.ceil(_ALPHA * s * 2**32 / n)))
    if cap is None or c >= 2**31:
        return _bottom_s_distinct_count(_shrink_chunked(h, s), s)[0]
    compact, ok = _compact_lt(h, c, cap)
    sk, d = _bottom_s_distinct_count(_shrink_chunked(compact, s), s)
    # d (distinct count of the shrunk survivors) >= s iff the survivors
    # held >= s distinct values: shrinking preserves the bottom-s
    # distinct set, so the comparison is exact on either side of s
    return jax.lax.cond(
        ok & (d >= s),
        lambda: sk,
        lambda: _bottom_s_distinct_count(_shrink_chunked(h, s), s)[0],
    )


def _isin_sorted(x: jax.Array, ref: jax.Array) -> jax.Array:
    """Membership of each ``x`` in sorted ``ref`` (SENTINEL tail ok)."""
    idx = jnp.minimum(
        jnp.searchsorted(ref, x), ref.shape[0] - 1
    )
    return jnp.take(ref, idx) == x


@functools.partial(
    jax.jit, static_argnames=("length", "k", "s", "canonical")
)
def bottom_k_sketch(
    words: jax.Array, length: int, k: int, s: int, *, canonical: bool = True
) -> jax.Array:
    """Bottom-``s`` MinHash sketch of one packed stream: -> sorted u32[s].

    The ``s`` smallest distinct canonical k-mer hashes (Mash's sketch);
    fewer than ``s`` distinct k-mers (including ``length < k``) leaves
    SENTINEL padding.  k <= 31.
    """
    if length < k:
        return jnp.full(s, SENTINEL, jnp.uint32)
    # planar-order hashes: a sketch is order-free, so the funnel-kernel
    # form (invalid slots pre-set to SENTINEL) replaces the gather-based
    # position-ordered hash pass (~25x device time at 4 Mnt)
    h = kmer.kmer_hashes_planar(words, length, k, canonical=canonical)
    return _bottom_s_distinct(h, s)


def _batch_hashes(
    words: jax.Array, lengths, k: int, canonical: bool, invalid=None
) -> jax.Array:
    """Canonical k-mer hashes of every read of a padded batch, flattened,
    with positions past each read's end set to SENTINEL (excluded from any
    sketch).  Windows never span reads: each row hashes independently.

    ``invalid`` (optional bool[B, L], True = not a real {A,C,G,T,U} base)
    additionally drops every k-mer whose window touches a flagged byte —
    the Mash/sourmash rule for ``N`` and other ambiguity codes, which the
    2-bit packing itself cannot represent.  A batch whose padded capacity
    is below ``k`` contributes no k-mers at all (one SENTINEL stands in so
    downstream reductions keep a static shape).
    """
    if words.ndim != 2:
        raise TypeError(f"expected u32[B, W] batch, got {words.shape}")
    B, Wr = words.shape
    L = Wr * spec.NT_PER_U32_2BIT
    if L < k:
        return jnp.full(1, SENTINEL, jnp.uint32)
    lengths = jnp.minimum(
        jnp.broadcast_to(jnp.asarray(lengths, jnp.int32).reshape(-1), (B,)),
        L,
    )
    if invalid is not None:
        inv = jnp.asarray(invalid)
        if inv.ndim != 2 or inv.shape[0] != B or inv.shape[1] > L:
            raise ValueError(
                f"invalid mask shape {inv.shape} incompatible with "
                f"byte capacity {(B, L)}"
            )
        if inv.shape[1] < L:
            # byte-length masks vs word-granular capacity: the gap is
            # encode padding, already excluded by the lengths mask
            inv = jnp.pad(inv, ((0, 0), (0, L - inv.shape[1])))

    def per_read(row, n, inv_row):
        h = kmer.kmer_hashes(row, L, k, canonical=canonical)
        pos = jnp.arange(h.shape[0])
        keep = pos < n - (k - 1)
        if inv_row is not None:
            # window-touches-invalid via an exclusive prefix sum: k-mer i
            # is dropped iff any byte in [i, i+k) is flagged
            cp = jnp.concatenate([
                jnp.zeros(1, jnp.int32),
                jnp.cumsum(inv_row.astype(jnp.int32)),
            ])
            keep &= (cp[k:] - cp[:-k]) == 0
        return jnp.where(keep, h, SENTINEL)

    if invalid is None:
        hashed = jax.vmap(lambda r, n: per_read(r, n, None))(words, lengths)
    else:
        hashed = jax.vmap(per_read)(words, lengths, inv)
    return hashed.reshape(-1)


@functools.partial(jax.jit, static_argnames=("k", "s", "canonical"))
def bottom_k_sketch_batch(
    words: jax.Array,
    lengths,
    k: int,
    s: int,
    *,
    canonical: bool = True,
    invalid=None,
) -> jax.Array:
    """One dataset-level bottom-``s`` sketch of a padded read batch:
    u32[B, W] + lengths -> sorted u32[s].

    The sketch of the UNION of every read's k-mers ('A'-padding tails and
    rows shorter than k are masked; windows never span read boundaries) —
    what one host shard contributes to a cluster-wide dataset sketch.
    ``invalid`` (bool[B, L]) drops k-mers touching flagged bytes (N etc.);
    see :func:`_batch_hashes`.
    """
    return _bottom_s_distinct(
        _batch_hashes(words, lengths, k, canonical, invalid), s
    )


@functools.partial(
    jax.jit, static_argnames=("length", "k", "scale", "cap", "canonical")
)
def frac_sketch(
    words: jax.Array,
    length: int,
    k: int,
    *,
    scale: int,
    cap: int,
    canonical: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """FracMinHash sketch: every distinct hash below ``2**32 // scale``
    -> (sorted u32[cap], n_kept i32).

    sourmash's scheme: an expected ``1/scale`` fraction of distinct k-mers
    is retained, so two datasets' sketches sample the SAME hash region and
    ``containment(a, b)`` is an unbiased estimate of true k-mer
    containment even at very different dataset sizes.  ``n_kept`` is the
    true number of distinct retained hashes — if it exceeds ``cap`` the
    buffer holds the smallest ``cap`` of them (still a valid sketch, but
    resize ``cap`` or raise ``scale`` to keep the full sample).
    """
    if length < k:
        h = jnp.full(1, SENTINEL, jnp.uint32)
    else:
        # planar order (see bottom_k_sketch): FracMinHash is order-free
        h = kmer.kmer_hashes_planar(words, length, k, canonical=canonical)
    return _frac_from_hashes(h, scale, cap)


@functools.partial(jax.jit, static_argnames=("k", "scale", "cap", "canonical"))
def frac_sketch_batch(
    words: jax.Array,
    lengths,
    k: int,
    *,
    scale: int,
    cap: int,
    canonical: bool = True,
    invalid=None,
) -> tuple[jax.Array, jax.Array]:
    """FracMinHash sketch of the union of a padded read batch's k-mers:
    u32[B, W] + lengths -> (sorted u32[cap], n_kept i32).

    The batch form of :func:`frac_sketch` (same masking rules as
    :func:`bottom_k_sketch_batch`, including the ``invalid`` byte mask).
    Frac sketches with a common ``scale`` union-merge exactly via
    :func:`merge` — every retained hash is already below the shared
    threshold, so the union needs no re-filtering.
    """
    h = _batch_hashes(words, lengths, k, canonical, invalid)
    return _frac_from_hashes(h, scale, cap)


def _frac_from_hashes(
    h: jax.Array, scale: int, cap: int
) -> tuple[jax.Array, jax.Array]:
    if scale < 1:
        raise ValueError("scale must be >= 1")
    thresh = min(2**32 // scale, 2**32 - 1)
    h = h.reshape(-1)
    s = max(cap, 1)
    # FracMinHash already IS a threshold filter — compact below the
    # (static) retention threshold before the distinct sort (r05).  The
    # capacity plan uses the uniform-hash expectation n*thresh/2**32;
    # ``ok`` guarantees ALL retained entries were captured, so both the
    # sketch and the exact n_kept distinct count come from the compacted
    # array; a capacity overflow (duplication-heavy or low-scale input)
    # falls back to the unfiltered sort.
    plan = _prefilter_plan(h.size, h.size * (thresh / 2**32))
    if plan is None:
        hm = jnp.where(h < jnp.uint32(thresh), h, SENTINEL)
        sk, n_kept = _bottom_s_distinct_count(hm, s)
        return sk[:cap], n_kept
    compact, ok = _compact_lt(h, thresh, plan)

    def _fast():
        return _bottom_s_distinct_count(compact, s)

    def _slow():
        hm = jnp.where(h < jnp.uint32(thresh), h, SENTINEL)
        return _bottom_s_distinct_count(hm, s)

    sk, n_kept = jax.lax.cond(ok, _fast, _slow)
    return sk[:cap], n_kept


@jax.jit
def merge(sa: jax.Array, sb: jax.Array) -> jax.Array:
    """Union-merge two sketches: -> the bottom-|sa| distinct hashes of
    ``sa ∪ sb``.  Associative and commutative, so per-shard sketches
    reduce to a dataset sketch in any order (mesh-friendly)."""
    if sa.shape != sb.shape:
        raise ValueError(f"sketch sizes differ: {sa.shape} vs {sb.shape}")
    return _bottom_s_distinct(jnp.concatenate([sa, sb]), sa.shape[0])


@jax.jit
def merge_many(stacked: jax.Array) -> jax.Array:
    """Union-merge D stacked same-size sketches in one pass:
    u32[D, s] -> sorted u32[s] — the bottom-``s`` distinct hashes of the
    union.  The N-way form of :func:`merge` (one sort of D*s elements
    instead of a reduction tree); this is what a device mesh applies to
    the ``all_gather`` of its per-shard sketches."""
    if stacked.ndim < 2:
        raise ValueError(f"expected stacked sketches [D, s], got {stacked.shape}")
    return _bottom_s_distinct(stacked.reshape(-1), stacked.shape[-1])


@jax.jit
def jaccard(sa: jax.Array, sb: jax.Array) -> jax.Array:
    """Jaccard similarity estimate from two same-size sketches: -> f32.

    Mash's estimator: of the bottom-s sketch of the UNION, the fraction
    also present in both input sketches.  Exact in expectation for
    bottom-s sketches of any two datasets; also valid for
    :func:`frac_sketch` pairs built with the same ``scale``.
    """
    u = merge(sa, sb)
    valid = u != SENTINEL
    inter = _isin_sorted(u, sa) & _isin_sorted(u, sb) & valid
    return jnp.sum(inter) / jnp.maximum(jnp.sum(valid), 1)


@jax.jit
def jaccard_matrix(stacked: jax.Array) -> jax.Array:
    """All-pairs Jaccard estimates of D same-size sketches:
    u32[D, s] -> f32[D, D] (one device dispatch instead of D² calls).

    Symmetric; the diagonal is 1 for any non-empty sketch (an all-SENTINEL
    sketch — an empty dataset — yields 0 everywhere, including with
    itself).
    """
    if stacked.ndim != 2:
        raise ValueError(f"expected stacked sketches [D, s], got {stacked.shape}")
    return jax.vmap(
        lambda sa: jax.vmap(lambda sb: jaccard(sa, sb))(stacked)
    )(stacked)


@jax.jit
def containment(sa: jax.Array, sb: jax.Array) -> jax.Array:
    """Containment estimate C(A in B) from two sketches: -> f32 — the
    fraction of ``sa``'s hashes present in ``sb``.

    Unbiased for :func:`frac_sketch` pairs with a common ``scale`` (the
    sketches sample the same hash region — sourmash's argument); for
    bottom-s sketches it is the usual heuristic and degrades when the
    datasets' sizes differ wildly.
    """
    va = sa != SENTINEL
    inter = _isin_sorted(sa, sb) & va
    return jnp.sum(inter) / jnp.maximum(jnp.sum(va), 1)


def mash_distance(j: float, k: int) -> float:
    """Mash distance (≈ per-base mutation rate) from a Jaccard estimate:
    ``-ln(2j / (1 + j)) / k``; 0 -> 1.0 (saturated)."""
    j = float(j)
    if j <= 0.0:
        return 1.0
    return min(-math.log(2.0 * j / (1.0 + j)) / k, 1.0)
