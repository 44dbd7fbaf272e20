"""Packed-domain k-mer extraction/counting vs a naive byte-domain reference."""

import numpy as np
import pytest

import jax.numpy as jnp

from cute_nucleotides_jax.ops import kmer, oracle, spec

CODE = {65: 0, 67: 1, 84: 2, 71: 3}  # A C T G (2-bit codes)
COMP = {0: 2, 1: 3, 2: 0, 3: 1}


def _naive_codes(seq: bytes, k: int) -> list[int]:
    s = seq.upper().replace(b"U", b"T")
    out = []
    for i in range(len(s) - k + 1):
        c = 0
        for j in range(k):
            c |= CODE[s[i + j]] << (2 * j)
        out.append(c)
    return out


def _naive_codes_np(seq: np.ndarray, k: int) -> np.ndarray:
    """Vectorized :func:`_naive_codes` (same LSB-first code layout)."""
    c = (seq.astype(np.int64) >> 1) & 3  # ASCII bits 1-2 == the 2-bit code
    n = seq.size - k + 1
    out = np.zeros(n, np.int64)
    for j in range(k):
        out |= c[j : j + n] << (2 * j)
    return out


def _naive_rc(code: int, k: int) -> int:
    out = 0
    for j in range(k):
        d = (code >> (2 * j)) & 3
        out |= COMP[d] << (2 * (k - 1 - j))
    return out


def _packed(seq: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(
        spec.u64_to_u32_pairs(oracle.n_to_bits_lut(seq)).reshape(-1)
    )


@pytest.mark.parametrize("k", [1, 3, 8, 15])
def test_kmer_codes(rng, k):
    s = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=100)
    got = np.asarray(kmer.kmer_codes(_packed(s), 100, k))
    assert got.tolist() == _naive_codes(bytes(s), k)


@pytest.mark.parametrize("k", [2, 5, 11, 15])
def test_revcomp_code(rng, k):
    codes = rng.integers(0, 4**k, size=50, dtype=np.int64).astype(np.int32)
    got = np.asarray(kmer.revcomp_code(jnp.asarray(codes), k))
    want = [_naive_rc(int(c), k) for c in codes]
    assert got.tolist() == want
    # involution
    back = np.asarray(kmer.revcomp_code(jnp.asarray(got), k))
    assert back.tolist() == codes.tolist()


def test_kmer_histogram(rng):
    k = 4
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=500)
    hist = np.asarray(kmer.kmer_histogram(_packed(s), 500, k))
    naive = np.zeros(4**k, np.int64)
    for c in _naive_codes(bytes(s), k):
        naive[c] += 1
    assert hist.tolist() == naive.tolist()
    assert hist.sum() == 500 - k + 1


def test_kmer_histogram_canonical(rng):
    k = 3
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200)
    hist = np.asarray(kmer.kmer_histogram(_packed(s), 200, k, canonical=True))
    naive = np.zeros(4**k, np.int64)
    for c in _naive_codes(bytes(s), k):
        naive[min(c, _naive_rc(c, k))] += 1
    assert hist.tolist() == naive.tolist()


@pytest.mark.parametrize("k,canonical", [(4, False), (8, True), (10, False)])
def test_kmer_histogram_batch_ragged(rng, k, canonical):
    """Batched spectrum == sum of per-read naive histograms over TRUE
    lengths: padding and read junctions contribute nothing."""
    B, L = 7, 96
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[0] = 0
    lengths[1] = k - 1  # shorter than k: zero windows
    lengths[2] = L
    want = np.zeros(4**k, np.int64)
    rows = []
    for b in range(B):
        seq = reads[b].copy()
        seq[lengths[b]:] = ord("A")  # batch padding convention
        rows.append(spec.u64_to_u32_pairs(oracle.n_to_bits_lut(seq)).reshape(-1))
        for c in _naive_codes(bytes(seq[: lengths[b]]), k):
            if canonical:
                c = min(c, _naive_rc(c, k))
            want[c] += 1
    words = jnp.asarray(np.stack(rows))
    got = np.asarray(
        kmer.kmer_histogram_batch(words, jnp.asarray(lengths), k, canonical=canonical)
    )
    assert got.sum() == want.sum() == np.maximum(lengths - k + 1, 0).sum()
    assert np.array_equal(got, want)


def test_kmer_histogram_batch_uniform_scalar_length(rng):
    """Scalar length broadcast; agrees with the flat kmer_histogram row sum."""
    B, L, k = 4, 64, 6
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    rows = [
        spec.u64_to_u32_pairs(oracle.n_to_bits_lut(reads[b])).reshape(-1)
        for b in range(B)
    ]
    words = jnp.asarray(np.stack(rows))
    got = np.asarray(kmer.kmer_histogram_batch(words, L, k))
    want = sum(
        np.asarray(kmer.kmer_histogram(jnp.asarray(r), L, k)) for r in rows
    )
    assert np.array_equal(got, want)


def test_kmer_histogram_batch_errors():
    w = jnp.zeros((2, 4), jnp.uint32)
    with pytest.raises(ValueError, match="k in \\[1, 12\\]"):
        kmer.kmer_histogram_batch(w, 64, 13)
    with pytest.raises(TypeError, match="batch"):
        kmer.kmer_histogram_batch(jnp.zeros(4, jnp.uint32), 64, 4)


def test_kmer_errors():
    w = jnp.zeros(2, jnp.uint32)
    with pytest.raises(ValueError):
        kmer.kmer_codes(w, 10, 16)
    with pytest.raises(ValueError):
        kmer.kmer_codes(w, 3, 5)
    with pytest.raises(ValueError):
        kmer.kmer_codes(w, 40, 4)


@pytest.mark.parametrize("k", [1, 4, 6, 8])
def test_kmer_histogram_matches_numpy(rng, k):
    """kmer_histogram == a NumPy bincount of the naive codes, including
    ragged lengths and the canonical fold."""
    for L in (k, 100, 16 * 512, 16 * 513 + 5, 40000):
        if L - k + 1 <= 0:
            continue
        seq = rng.choice(np.frombuffer(b"ACGTacgtu", np.uint8), L)
        w = _packed(seq)
        codes = np.asarray(_naive_codes_np(seq, k))
        want = np.bincount(codes, minlength=4**k)
        got = np.asarray(kmer.kmer_histogram(w, L, k))
        assert np.array_equal(got, want), (L, k)
        rc = np.array([_naive_rc(int(v), k) for v in codes[:2000]], np.int64)
        canon = np.minimum(codes[:2000], rc)
        gotc = np.asarray(kmer.kmer_histogram(w, L, k, canonical=True))
        if L - k + 1 <= 2000:
            assert np.array_equal(gotc, np.bincount(canon, minlength=4**k))
        wantc = np.asarray(
            kmer._kmer_histogram_scatter(w, L, k, canonical=True)
        )
        assert np.array_equal(gotc, wantc), (L, k, "canonical")


def test_kmer_codes_planar_is_position_permutation(rng):
    """Planar output at col W*s + w of row r == the gather code at
    position 16*(r*W + w) + s (bit-exact, full funnel across word bounds)."""
    k, W = 8, 512
    L = 40000
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), L)
    w32 = np.asarray(_packed(seq))
    want = np.asarray(kmer.kmer_codes(jnp.asarray(w32), L, k))
    rows = -(-w32.size // W)
    pad = rows * W - w32.size
    flat = np.concatenate([w32, np.zeros(pad, np.uint32)])
    nxt = np.concatenate([w32[1:], np.zeros(pad + 1, np.uint32)])
    planar = np.asarray(
        kmer.kmer_codes_planar(
            jnp.asarray(flat.reshape(rows, W)),
            jnp.asarray(nxt.reshape(rows, W)),
            k,
        )
    )
    pos = (
        16 * (np.arange(rows)[:, None, None] * W + np.arange(W)[None, None, :])
        + np.arange(16)[None, :, None]
    )
    reordered = np.empty(16 * rows * W, np.int32)
    reordered[pos.reshape(-1)] = planar.reshape(rows, 16, W).reshape(-1)
    assert np.array_equal(reordered[: want.size], want)


def test_kmer_histogram_dispatcher():
    w = jnp.zeros(64, jnp.uint32)  # 1024 'A's
    h8 = np.asarray(kmer.kmer_histogram(w, 1024, 8))
    assert h8[0] == 1024 - 8 + 1 and h8[1:].sum() == 0
    h9 = np.asarray(kmer.kmer_histogram(w, 1024, 9))
    assert h9[0] == 1024 - 9 + 1 and h9[1:].sum() == 0


# --- production k (u32-pair codes, k <= 31) ---------------------------------


@pytest.mark.parametrize("k", [16, 17, 21, 31])
def test_kmer_codes_pair(rng, k):
    s = rng.choice(np.frombuffer(b"ACGTU", np.uint8), size=150)
    lo, hi = kmer.kmer_codes_pair(_packed(s), 150, k)
    got = (np.asarray(hi).astype(np.uint64) << 32) | np.asarray(lo).astype(
        np.uint64
    )
    want = np.array(_naive_codes(bytes(s), k), np.uint64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [16, 21, 31])
def test_revcomp_and_canonical_pair(rng, k):
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=120)
    lo, hi = kmer.kmer_codes_pair(_packed(s), 120, k)
    want = np.array(_naive_codes(bytes(s), k), np.uint64)
    want_rc = np.array([_naive_rc(int(v), k) for v in want], np.uint64)
    rlo, rhi = kmer.revcomp_code_pair(lo, hi, k)
    got_rc = (np.asarray(rhi).astype(np.uint64) << 32) | np.asarray(
        rlo
    ).astype(np.uint64)
    assert np.array_equal(got_rc, want_rc)
    clo, chi = kmer.canonical_codes_pair(lo, hi, k)
    got_c = (np.asarray(chi).astype(np.uint64) << 32) | np.asarray(clo).astype(
        np.uint64
    )
    assert np.array_equal(got_c, np.minimum(want, want_rc))


@pytest.mark.parametrize("k", [4, 15, 16, 21, 31])
@pytest.mark.parametrize("canonical", [False, True])
def test_kmer_counts_matches_counter(rng, k, canonical):
    """Sorted-segment counts == a Python Counter over the naive codes."""
    from collections import Counter

    L = 333
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    lo_s, hi_s, counts = map(
        np.asarray, kmer.kmer_counts(_packed(s), L, k, canonical=canonical)
    )
    got = {
        (int(hi_s[i]) << 32) | int(lo_s[i]): int(counts[i])
        for i in np.nonzero(counts)[0]
    }
    codes = _naive_codes(bytes(s), k)
    if canonical:
        codes = [min(v, _naive_rc(v, k)) for v in codes]
    assert got == dict(Counter(codes))
    assert counts.sum() == L - k + 1


def test_kmer_counts_errors():
    w = jnp.zeros(64, jnp.uint32)
    with pytest.raises(ValueError, match=r"\[1, 31\]"):
        kmer.kmer_counts(w, 100, 32)
    with pytest.raises(ValueError, match="too short"):
        kmer.kmer_counts(w, 10, 21)
    with pytest.raises(ValueError, match="use kmer_counts"):
        kmer.kmer_histogram(w, 1024, 13)


def test_kmer_codes_planar_pair_is_position_permutation(rng):
    """Planar pair cols (W s + w) hold the pair for position 16(rW+w)+s."""
    k = 21
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=3 * 16 * 128)
    w32 = np.asarray(_packed(seq))
    rows, W = 3, 128
    panels = w32.reshape(rows, W)
    nxt = np.roll(w32, -1).reshape(rows, W)
    nxt2 = np.roll(w32, -2).reshape(rows, W)
    nxt[-1, -1] = 0
    nxt2[-1, -1] = 0
    nxt2[-1, -2] = 0
    lo, hi = map(
        np.asarray,
        kmer.kmer_codes_planar_pair(
            jnp.asarray(panels), jnp.asarray(nxt), jnp.asarray(nxt2), k
        ),
    )
    got = (hi.astype(np.uint64) << 32) | lo.astype(np.uint64)
    want = np.array(_naive_codes(bytes(seq), k), np.uint64)
    col = np.arange(16 * W)
    pos = (
        16 * (np.arange(rows)[:, None] * W + col[None, :] % W) + col[None, :] // W
    )
    reordered = np.empty(16 * rows * W, np.uint64)
    reordered[pos.reshape(-1)] = got.reshape(-1)
    assert np.array_equal(reordered[: want.size], want)


def _naive_minimizers(h: np.ndarray, w: int) -> set:
    n = len(h)
    if n <= w:
        return set(np.nonzero(h == h.min())[0].tolist())
    out = set()
    for j in range(n - w + 1):
        m = h[j : j + w].min()
        out.update(j + i for i in range(w) if h[j + i] == m)
    return out


@pytest.mark.parametrize("k,w", [(5, 1), (15, 10), (21, 11), (31, 5), (8, 64)])
def test_minimizers_match_naive(rng, k, w):
    L = 300
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    mask, h = map(np.asarray, kmer.minimizers(_packed(s), L, k, w))
    assert set(np.nonzero(mask)[0].tolist()) == _naive_minimizers(h, w)


def test_minimizers_canonical_revcomp_invariant(rng):
    """A read and its reverse complement sketch the same minimizer set."""
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=301)
    rc = np.frombuffer(
        bytes(s).translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1], np.uint8
    )
    m1, h1 = map(np.asarray, kmer.minimizers(_packed(s), 301, 21, 11))
    m2, h2 = map(np.asarray, kmer.minimizers(_packed(rc), 301, 21, 11))
    assert sorted(h1[m1].tolist()) == sorted(h2[m2].tolist())


def test_minimizers_short_read_and_errors(rng):
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=40)
    mask, h = map(np.asarray, kmer.minimizers(_packed(s), 40, 31, 64))
    assert mask.sum() >= 1 and np.all(h[mask] == h.min())
    with pytest.raises(ValueError, match="w must be"):
        kmer.minimizers(_packed(s), 40, 15, 0)


# --- long streams (the sizes a fused minimizer scan once served) -----------


def _minimizers_np(h: np.ndarray, w: int) -> np.ndarray:
    """Vectorized NumPy oracle of the minimizer rule: window minima, then
    the largest window minimum among the windows holding each position."""
    from numpy.lib.stride_tricks import sliding_window_view

    n = h.size
    wm = sliding_window_view(h, w).min(axis=1)  # n - w + 1 window minima
    padded = np.concatenate([np.zeros(w - 1, h.dtype), wm, np.zeros(w - 1, h.dtype)])
    best = sliding_window_view(padded, w).max(axis=1)[:n]
    return h == best


@pytest.mark.parametrize(
    "L,k,w,canonical",
    [
        (16 * 1024 + 5, 15, 10, True),
        (16 * 2048, 15, 10, True),
        (16 * 1500, 7, 64, False),
        (16 * 1100 + 3, 15, 2033, True),
        (16 * 1024, 1, 5, True),
    ],
)
def test_minimizers_long_stream_match_numpy(rng, L, k, w, canonical):
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    words = _packed(s)
    got, h = kmer.minimizers(words, L, k, w, canonical=canonical)
    want = _minimizers_np(np.asarray(h), w)
    assert np.array_equal(np.asarray(got), want)


@pytest.mark.parametrize("L,k,w", [(16 * 1024 + 5, 15, 10), (5000, 15, 10)])
def test_minimizer_bits_packed_contract(rng, L, k, w):
    """Packed bits unpack to the boolean mask on both routes, with every
    bit at position >= n cleared."""
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    words = _packed(s)
    n = L - k + 1
    bits = np.asarray(kmer.minimizer_bits(words, L, k, w))
    assert bits.shape == (-(-n // 16),) and bits.dtype == np.uint32
    unp = ((bits[:, None] >> np.arange(16)) & 1).astype(bool).reshape(-1)
    mask, _ = kmer.minimizers(words, L, k, w)
    assert np.array_equal(unp[:n], np.asarray(mask))
    assert not unp[n:].any()


def test_minimizer_bits_short_read_single_window(rng):
    """n <= w: one partial window, every minimum-hash position flagged."""
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=40)
    words = _packed(s)
    bits = np.asarray(kmer.minimizer_bits(words, 40, 31, 64))
    mask, h = map(np.asarray, kmer.minimizers(words, 40, 31, 64))
    unp = ((bits[:, None] >> np.arange(16)) & 1).astype(bool).reshape(-1)
    assert np.array_equal(unp[: mask.size], mask) and not unp[mask.size :].any()
    assert np.all(h[mask] == h.min())


@pytest.mark.parametrize(
    "L,k,canonical",
    [(16 * 600 + 7, 21, True), (16 * 600, 31, False), (16 * 520 + 1, 16, True),
     (5000, 15, True), (300, 8, True), (40, 31, True)],
)
def test_kmer_hashes_planar_multiset(rng, L, k, canonical):
    """Planar hashes = the position-ordered gather hashes as a multiset,
    with every invalid/padded slot at SENTINEL."""
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    w = _packed(s)
    hp = np.asarray(kmer.kmer_hashes_planar(w, L, k, canonical=canonical))
    hr = np.sort(np.asarray(kmer.kmer_hashes(w, L, k, canonical=canonical)))
    n = L - k + 1
    assert (hp == 0xFFFFFFFF).sum() >= hp.size - n  # pads are SENTINEL
    assert np.array_equal(
        np.sort(hp[hp != 0xFFFFFFFF]), hr[hr != 0xFFFFFFFF]
    )
