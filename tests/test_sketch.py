"""MinHash sketching vs a pure-Python set oracle (Mash/sourmash semantics)."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from cute_nucleotides_jax.ops import oracle, sketch, spec
from cute_nucleotides_jax import parallel

CODE = {65: 0, 67: 1, 84: 2, 71: 3}  # A C T G
COMP = {0: 2, 1: 3, 2: 0, 3: 1}
SENT = 0xFFFFFFFF


def _packed(seq) -> jnp.ndarray:
    return jnp.asarray(
        spec.u64_to_u32_pairs(oracle.n_to_bits_lut(np.asarray(seq))).reshape(-1)
    )


def _packed_batch(reads: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(
        np.stack([np.asarray(_packed(r)) for r in reads])
    )


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _naive_hashes(seq: bytes, k: int, canonical: bool = True) -> list[int]:
    """Canonical k-mer hashes, independent of ops.kmer (python ints only)."""
    s = seq.upper().replace(b"U", b"T")
    out = []
    for i in range(len(s) - k + 1):
        c = 0
        for j in range(k):
            c |= CODE[s[i + j]] << (2 * j)
        if canonical:
            rc = 0
            for j in range(k):
                rc |= COMP[(c >> (2 * j)) & 3] << (2 * (k - 1 - j))
            c = min(c, rc)
        if k <= 15:
            out.append(_fmix32(c))
        else:
            lo, hi = c & 0xFFFFFFFF, c >> 32
            out.append(_fmix32(lo ^ _fmix32(hi)))
    return out


def _naive_bottom_s(hashes, s: int) -> list[int]:
    keep = sorted(set(hashes))[:s]
    return keep + [SENT] * (s - len(keep))


@pytest.mark.parametrize("k", [5, 11, 21])
def test_bottom_k_sketch_matches_set_oracle(rng, k):
    s_sz = 24
    seq = rng.choice(np.frombuffer(b"ACGTacgtu", np.uint8), size=320)
    got = np.asarray(sketch.bottom_k_sketch(_packed(seq), 320, k, s_sz))
    assert got.tolist() == _naive_bottom_s(_naive_hashes(bytes(seq), k), s_sz)


def test_bottom_k_sketch_sentinel_padding(rng):
    # 10 nt, k=7 -> at most 4 distinct hashes; the rest must be SENTINEL
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=10)
    got = np.asarray(sketch.bottom_k_sketch(_packed(seq), 10, 7, 16))
    want = _naive_bottom_s(_naive_hashes(bytes(seq), 7), 16)
    assert got.tolist() == want
    assert (got == SENT).sum() >= 12


def test_bottom_k_sketch_revcomp_invariant(rng):
    """Canonical sketches of a read and its reverse complement agree."""
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200)
    rc = np.asarray(
        [b"TGCA"[b"ACGT".index(bytes([c]))] for c in seq[::-1]], np.uint8
    )
    a = np.asarray(sketch.bottom_k_sketch(_packed(seq), 200, 9, 32))
    b = np.asarray(sketch.bottom_k_sketch(_packed(rc), 200, 9, 32))
    assert np.array_equal(a, b)


def test_batch_sketch_masks_ragged_tails(rng):
    """Union over reads; 'A'-padding and sub-k rows contribute nothing."""
    B, L, k, s_sz = 6, 64, 8, 48
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lengths = np.array([64, 40, 8, 0, 5, 33], np.int32)  # incl. rows < k
    for b in range(B):
        reads[b, lengths[b]:] = ord("A")
    got = np.asarray(
        sketch.bottom_k_sketch_batch(
            _packed_batch(reads), jnp.asarray(lengths), k, s_sz
        )
    )
    allh = []
    for b in range(B):
        allh += _naive_hashes(bytes(reads[b, : lengths[b]]), k)
    assert got.tolist() == _naive_bottom_s(allh, s_sz)


def test_frac_sketch_threshold_and_count(rng):
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400)
    k, scale, cap = 9, 4, 64
    sk, n_kept = sketch.frac_sketch(
        _packed(seq), 400, k, scale=scale, cap=cap
    )
    sk, n_kept = np.asarray(sk), int(n_kept)
    thresh = 2**32 // scale
    want = sorted({h for h in _naive_hashes(bytes(seq), k) if h < thresh})
    assert n_kept == len(want)
    assert sk.tolist() == want[:cap] + [SENT] * (cap - min(len(want), cap))


def test_merge_is_bottom_s_of_union(rng):
    s_sz = 16
    a = np.sort(rng.integers(0, 2**32 - 1, 16, dtype=np.uint64)).astype(
        np.uint32
    )
    b = np.sort(rng.integers(0, 2**32 - 1, 16, dtype=np.uint64)).astype(
        np.uint32
    )
    m = np.asarray(sketch.merge(jnp.asarray(a), jnp.asarray(b)))
    assert m.tolist() == _naive_bottom_s(a.tolist() + b.tolist(), s_sz)
    # associative + commutative
    c = np.sort(rng.integers(0, 2**32 - 1, 16, dtype=np.uint64)).astype(
        np.uint32
    )
    ja, jb, jc = map(jnp.asarray, (a, b, c))
    left = np.asarray(sketch.merge(sketch.merge(ja, jb), jc))
    right = np.asarray(sketch.merge(ja, sketch.merge(jb, jc)))
    assert np.array_equal(left, right)
    assert np.array_equal(
        np.asarray(sketch.merge(ja, jb)), np.asarray(sketch.merge(jb, ja))
    )


def test_jaccard_exact_when_sketch_holds_everything(rng):
    """s >= |union| makes the estimator exact: compare to true Jaccard."""
    k, s_sz = 9, 512
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=150)
    other = base.copy()
    other[60:90] = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=30)
    sa = sketch.bottom_k_sketch(_packed(base), 150, k, s_sz)
    sb = sketch.bottom_k_sketch(_packed(other), 150, k, s_sz)
    ha = set(_naive_hashes(bytes(base), k))
    hb = set(_naive_hashes(bytes(other), k))
    want = len(ha & hb) / len(ha | hb)
    assert float(sketch.jaccard(sa, sb)) == pytest.approx(want, abs=1e-6)
    assert float(sketch.jaccard(sa, sa)) == pytest.approx(1.0)


def test_containment_exact_with_scale_one(rng):
    """scale=1 frac sketches retain every distinct hash -> exact C(A in B)."""
    k = 7
    big = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=300)
    sub = big[40:140]  # a true substring: every sub k-mer is contained
    sa, _ = sketch.frac_sketch(_packed(sub), 100, k, scale=1, cap=256)
    sb, _ = sketch.frac_sketch(_packed(big), 300, k, scale=1, cap=512)
    assert float(sketch.containment(sa, sb)) == pytest.approx(1.0)
    ha = set(_naive_hashes(bytes(sub), k))
    hb = set(_naive_hashes(bytes(big[:150]), k))
    sc, _ = sketch.frac_sketch(_packed(big[:150]), 150, k, scale=1, cap=512)
    want = len(ha & hb) / len(ha)
    assert float(sketch.containment(sa, sc)) == pytest.approx(want, abs=1e-6)


def test_mash_distance_edge_cases():
    assert sketch.mash_distance(1.0, 21) == pytest.approx(0.0)
    assert sketch.mash_distance(0.0, 21) == 1.0
    j = 0.3
    want = -math.log(2 * j / (1 + j)) / 21
    assert sketch.mash_distance(j, 21) == pytest.approx(want)


def test_sketch_sharded_matches_single_device(rng):
    """all_gather union-merge over the 8-device mesh == one-device sketch."""
    B, L, k, s_sz = 16, 96, 11, 64
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    for b in range(B):
        reads[b, lengths[b]:] = ord("A")
    words = _packed_batch(reads)
    got = np.asarray(
        parallel.sketch_sharded(words, jnp.asarray(lengths), k, s_sz)
    )
    want = np.asarray(
        sketch.bottom_k_sketch_batch(words, jnp.asarray(lengths), k, s_sz)
    )
    assert np.array_equal(got, want)


def test_frac_sketch_batch_matches_union(rng):
    B, L, k, scale, cap = 4, 80, 7, 3, 128
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lengths = np.array([80, 33, 5, 60], np.int32)
    for b in range(B):
        reads[b, lengths[b]:] = ord("A")
    sk, n_kept = sketch.frac_sketch_batch(
        _packed_batch(reads), jnp.asarray(lengths), k, scale=scale, cap=cap
    )
    thresh = 2**32 // scale
    allh = set()
    for b in range(B):
        allh |= {
            h for h in _naive_hashes(bytes(reads[b, : lengths[b]]), k)
            if h < thresh
        }
    want = sorted(allh)
    assert int(n_kept) == len(want)
    assert np.asarray(sk).tolist() == want[:cap] + [SENT] * (cap - len(want))


def test_invalid_mask_drops_touching_kmers(rng):
    """k-mers whose window touches a flagged byte (N etc.) are dropped."""
    B, L, k, s_sz = 3, 48, 6, 128
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    # plant N runs; the packing itself will encode them as G — the mask is
    # what keeps them out of the sketch
    nmask = np.zeros((B, L), bool)
    nmask[0, 10] = True
    nmask[1, 20:25] = True
    reads_n = reads.copy()
    reads_n[nmask] = ord("N")
    # pack the N-planted reads via the defined (b>>1)&3 fallback (N -> G)
    packed = _packed_batch(
        np.where(nmask, ord("G"), reads_n).astype(np.uint8)
    )
    lengths = np.full(B, L, np.int32)
    got = np.asarray(
        sketch.bottom_k_sketch_batch(
            packed, jnp.asarray(lengths), k, s_sz,
            invalid=jnp.asarray(nmask),
        )
    )
    allh = []
    for b in range(B):
        seq = bytes(np.where(nmask[b], ord("G"), reads[b]).astype(np.uint8))
        for i in range(L - k + 1):
            if nmask[b, i : i + k].any():
                continue
            allh += _naive_hashes(seq[i : i + k], k)
    assert got.tolist() == _naive_bottom_s(allh, s_sz)
    # and the mask actually changes the sketch (G-aliased k-mers differ)
    unmasked = np.asarray(
        sketch.bottom_k_sketch_batch(packed, jnp.asarray(lengths), k, s_sz)
    )
    assert not np.array_equal(got, unmasked)


def test_capacity_below_k_contributes_nothing(rng):
    """A batch whose padded capacity is < k must not crash (issue found in
    review: empty .nup records killed whole sketch runs)."""
    words = jnp.zeros((3, 0), jnp.uint32)  # zero capacity
    got = np.asarray(
        sketch.bottom_k_sketch_batch(words, jnp.zeros(3, jnp.int32), 5, 8)
    )
    assert (got == SENT).all()
    sk, n = sketch.frac_sketch_batch(
        words, jnp.zeros(3, jnp.int32), 5, scale=1, cap=8
    )
    assert (np.asarray(sk) == SENT).all() and int(n) == 0
    # single-stream guard too
    one = _packed(np.frombuffer(b"ACGTACGTACGTACGT", np.uint8))
    got1 = np.asarray(sketch.bottom_k_sketch(one, 3, 9, 8))
    assert (got1 == SENT).all()
    sk1, n1 = sketch.frac_sketch(one, 3, 9, scale=1, cap=8)
    assert (np.asarray(sk1) == SENT).all() and int(n1) == 0


def test_merge_many_equals_pairwise_chain(rng):
    s_sz = 32
    sketches = [
        np.sort(rng.integers(0, 2**32 - 1, s_sz, dtype=np.uint64)).astype(
            np.uint32
        )
        for _ in range(5)
    ]
    acc = jnp.asarray(sketches[0])
    for sk in sketches[1:]:
        acc = sketch.merge(acc, jnp.asarray(sk))
    got = np.asarray(sketch.merge_many(jnp.asarray(np.stack(sketches))))
    assert np.array_equal(got, np.asarray(acc))


def test_chunked_bottom_s_exact_on_large_inputs(rng):
    """The chunked reduction path (inputs > 4 * _CHUNK) must equal the
    naive global bottom-s, including heavy cross- and within-chunk
    duplication pushing distinct values past chunk position s."""
    n = 5 * sketch._CHUNK + 137
    s_sz = 100
    # small value range -> massive duplication everywhere
    h = rng.integers(0, 4000, n, dtype=np.uint64).astype(np.uint32)
    # one chunk dominated by a single tiny value, hiding mid values
    h[: sketch._CHUNK - 5] = 1
    got = np.asarray(sketch._bottom_s_distinct(jnp.asarray(h), s_sz))
    assert got.tolist() == _naive_bottom_s(h.tolist(), s_sz)
    # and through the public sketch surface at a large-ish stream
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=70000)
    got_sk = np.asarray(sketch.bottom_k_sketch(_packed(seq), 70000, 13, 64))
    assert got_sk.tolist() == _naive_bottom_s(
        _naive_hashes(bytes(seq), 13), 64
    )


def test_prefiltered_bottom_s_exact_on_large_inputs(rng):
    """The r05 threshold-prefilter fast path (inputs >= _PREFILTER_MIN)
    must equal the naive global bottom-s on a uniform-hash-like input."""
    n = sketch._PREFILTER_MIN + 4093
    s_sz = 256
    h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    assert sketch._prefilter_plan(n, sketch._ALPHA * s_sz) is not None
    got = np.asarray(sketch._bottom_s_distinct(jnp.asarray(h), s_sz))
    assert got.tolist() == _naive_bottom_s(h.tolist(), s_sz)


def test_prefilter_underflow_falls_back_exactly(rng):
    """Heavy duplication: fewer than s distinct values below the static
    cutoff -> the d >= s guard must route to the unfiltered path and the
    result must still be the exact global bottom-s."""
    n = sketch._PREFILTER_MIN
    s_sz = 128
    # only 40 distinct values in the whole input, all huge (above any
    # reasonable prefilter cutoff) -> zero survivors, d = 0 < s
    vals = rng.integers(2**31, 2**32 - 2, 40, dtype=np.uint64).astype(
        np.uint32
    )
    h = vals[rng.integers(0, 40, n)]
    got = np.asarray(sketch._bottom_s_distinct(jnp.asarray(h), s_sz))
    assert got.tolist() == _naive_bottom_s(h.tolist(), s_sz)


def test_prefilter_overflow_falls_back_exactly(rng):
    """A 128-lane row holding more survivors than the static capacity
    (possible only under adversarial duplication) must be detected by
    _compact_lt's ok flag and fall back to the exact path."""
    n = sketch._PREFILTER_MIN
    s_sz = 64
    cap = sketch._prefilter_plan(n, sketch._ALPHA * s_sz)
    assert cap is not None
    h = np.full(n, 0xF0000000, np.uint32)
    # flood one aligned 128-lane row with tiny (surviving) duplicates
    h[256 : 256 + cap + 8] = 3
    h[: s_sz * 2] = rng.integers(0, 2**32, s_sz * 2, dtype=np.uint64).astype(
        np.uint32
    )
    c = min(2**32 - 1, -(-sketch._ALPHA * s_sz * 2**32 // n))
    _, ok = sketch._compact_lt(jnp.asarray(h), c, cap)
    assert not bool(ok)
    got = np.asarray(sketch._bottom_s_distinct(jnp.asarray(h), s_sz))
    assert got.tolist() == _naive_bottom_s(h.tolist(), s_sz)


def test_frac_prefilter_exact_sketch_and_count(rng):
    """frac path through _compact_lt: sketch AND the exact distinct
    n_kept must match the naive filter on a large input, including
    duplicates below the threshold."""
    n = sketch._PREFILTER_MIN + 511
    scale, cap = 2000, 256
    thresh = 2**32 // scale
    h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    h[::97] = h[1::97]  # inject duplicates, some below the threshold
    sk, n_kept = sketch._frac_from_hashes(jnp.asarray(h), scale, cap)
    kept = sorted({int(v) for v in h if v < thresh})
    want = (kept + [SENT] * cap)[:cap]
    assert np.asarray(sk).tolist() == want
    assert int(n_kept) == len(kept)


def test_frac_prefilter_overflow_falls_back(rng):
    """Low scale (wide retention) on a large input must either skip the
    prefilter statically or detect capacity overflow — always exact."""
    n = sketch._PREFILTER_MIN
    scale, cap = 4, 512  # keeps ~25% of entries: plan must be None
    assert sketch._prefilter_plan(n, n * (2**32 // scale) / 2**32) is None
    h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    sk, n_kept = sketch._frac_from_hashes(jnp.asarray(h), scale, cap)
    kept = sorted({int(v) for v in h if v < 2**32 // scale})
    assert np.asarray(sk).tolist() == kept[:cap]
    assert int(n_kept) == len(kept)


def test_large_sketch_size_terminates_and_exact(rng):
    """Sketch sizes at/above the chunk width must terminate (r05 review:
    the shrink loop had a fixed point for s >= ~0.8*_CHUNK and hung at
    trace time) and stay exact vs the set oracle."""
    n = 600_000
    for s_sz in (sketch._CHUNK, sketch._CHUNK + 500, 10_000):
        h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        got = np.asarray(sketch._bottom_s_distinct(jnp.asarray(h), s_sz))
        assert got.tolist() == _naive_bottom_s(h.tolist(), s_sz), s_sz


def test_prefilter_density_sweep_fuzz(rng):
    """Randomized density sweep of the r05 prefilter: hash distributions
    from uniform (fast path) through clustered-low (overflow-ish) to
    few-distinct (underflow fallback) must all equal the naive oracle."""
    n = sketch._PREFILTER_MIN + 777
    for trial, s_sz in enumerate((32, 100, 500)):
        kind = trial % 3
        if kind == 0:
            h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        elif kind == 1:
            # clustered low values: many survivors per 128-row
            h = rng.integers(0, 50000, n, dtype=np.uint64).astype(np.uint32)
        else:
            # few distinct values, mixed magnitudes
            vals = rng.integers(0, 2**32, 60, dtype=np.uint64).astype(
                np.uint32
            )
            h = vals[rng.integers(0, 60, n)]
        got = np.asarray(sketch._bottom_s_distinct(jnp.asarray(h), s_sz))
        assert got.tolist() == _naive_bottom_s(h.tolist(), s_sz), (
            trial,
            s_sz,
        )


def test_jaccard_matrix_matches_pairwise(rng):
    k, s_sz, D = 9, 128, 4
    seqs = [
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=250)
        for _ in range(D)
    ]
    seqs[2] = seqs[0].copy()  # one identical pair
    sks = jnp.asarray(np.stack([
        np.asarray(sketch.bottom_k_sketch(_packed(s), 250, k, s_sz))
        for s in seqs
    ]))
    m = np.asarray(sketch.jaccard_matrix(sks))
    assert m.shape == (D, D)
    for i in range(D):
        for j in range(D):
            want = float(sketch.jaccard(sks[i], sks[j]))
            assert m[i, j] == pytest.approx(want, abs=1e-6)
    assert np.allclose(m, m.T)
    assert m[0, 2] == pytest.approx(1.0) and m[1, 1] == pytest.approx(1.0)
    # empty dataset row is all zeros, even its own diagonal
    sks0 = jnp.concatenate(
        [sks, jnp.full((1, s_sz), sketch.SENTINEL, jnp.uint32)]
    )
    m0 = np.asarray(sketch.jaccard_matrix(sks0))
    assert (m0[-1] == 0).all() and (m0[:, -1] == 0).all()
