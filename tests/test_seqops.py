"""Packed-domain sequence ops: reverse complement, GC content."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cute_nucleotides_jax.ops import oracle, seqops, spec, xla

COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _revcomp(seq: bytes) -> bytes:
    return seq.upper().replace(b"U", b"T").translate(COMP)[::-1]


@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 32, 33, 1000])
def test_revcomp_packed(rng, n):
    s = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=n)
    w64 = oracle.n_to_bits_lut(s)
    w32 = jnp.asarray(spec.u64_to_u32_pairs(w64).reshape(-1))
    got = np.asarray(seqops.revcomp_packed(w32, n))
    want64 = oracle.n_to_bits_lut(np.frombuffer(_revcomp(bytes(s)), np.uint8))
    want = spec.u64_to_u32_pairs(want64).reshape(-1)
    assert np.array_equal(got, want), (n, got, want)


def test_complement_packed_roundtrip(rng):
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=64)
    w = jnp.asarray(spec.u64_to_u32_pairs(oracle.n_to_bits_lut(s)).reshape(-1))
    twice = seqops.complement_packed(seqops.complement_packed(w))
    assert np.array_equal(np.asarray(twice), np.asarray(w))


@pytest.mark.parametrize("n", [5, 32, 1000])
def test_gc_content(rng, n):
    s = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=n)
    want = sum(1 for c in bytes(s).upper() if c in b"CG")
    w = jnp.asarray(spec.u64_to_u32_pairs(oracle.n_to_bits_lut(s)).reshape(-1))
    assert int(seqops.gc_content_packed(w)) == want
    assert int(seqops.gc_content_bytes(jnp.asarray(s))) == want


def test_gc_content_batched(rng):
    batch = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(4, 64))
    words = jax.jit(xla.encode_2bit_words)(jnp.asarray(batch))
    got = np.asarray(seqops.gc_content_packed(words))
    want = [(row == ord("C")).sum() + (row == ord("G")).sum() for row in batch]
    assert got.tolist() == want


@pytest.mark.parametrize("n", [1, 26, 27, 28, 54, 1000])
def test_gc_content_packed_b5(rng, n):
    s = rng.choice(np.frombuffer(b"ACGTUNacgtun", np.uint8), size=n)
    up = bytes(s).upper()
    want_gc = sum(1 for c in up if c in b"CG")
    want_n = up.count(ord("N"))
    w = jnp.asarray(spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(s)).reshape(-1))
    assert int(seqops.gc_content_packed_b5(w)) == want_gc
    assert int(seqops.n_count_packed_b5(w)) == want_n


def test_b5_packed_counts_batched(rng):
    batch = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(4, 54))
    words = jax.jit(xla.encode_b5_words)(jnp.asarray(batch))
    got_gc = np.asarray(seqops.gc_content_packed_b5(words))
    got_n = np.asarray(seqops.n_count_packed_b5(words))
    for b in range(4):
        assert got_gc[b] == ((batch[b] == ord("C")) | (batch[b] == ord("G"))).sum()
        assert got_n[b] == (batch[b] == ord("N")).sum()


def test_first_invalid_word_b5(rng):
    s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=27 * 10)
    w64 = oracle.n_to_bits2_lut(s)
    w = spec.u64_to_u32_pairs(w64).reshape(-1)
    assert int(seqops.first_invalid_word_b5(jnp.asarray(w))) == -1
    # corrupt word 4 with an out-of-range triplet value (125 at offset 0)
    bad = w.copy()
    bad[8] = (bad[8] & ~np.uint32(0x7F)) | np.uint32(125)
    assert int(seqops.first_invalid_word_b5(jnp.asarray(bad))) == 4
    # pad bit 63 set flags too
    bad2 = w.copy()
    bad2[2 * 7 + 1] |= np.uint32(1 << 31)
    assert int(seqops.first_invalid_word_b5(jnp.asarray(bad2))) == 7


def test_first_invalid_word_b5_empty():
    assert int(seqops.first_invalid_word_b5(jnp.zeros(0, jnp.uint32))) == -1


@pytest.mark.parametrize("n", [5, 32, 33, 1000])
def test_base_composition_packed(rng, n):
    s = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=n)
    up = bytes(s).upper().replace(b"U", b"T")
    w = jnp.asarray(spec.u64_to_u32_pairs(oracle.n_to_bits_lut(s)).reshape(-1))
    got = np.asarray(seqops.base_composition_packed(w, n))
    want = [up.count(c) for c in b"ACTG"]
    assert got.tolist() == want
    assert got.sum() == n
    # without length, tail padding counts as A
    got_pad = np.asarray(seqops.base_composition_packed(w))
    assert got_pad.tolist() == [want[0] + (w.size * 16 - n), *want[1:]]


def test_base_composition_packed_batched(rng):
    batch = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(4, 64))
    words = jax.jit(xla.encode_2bit_words)(jnp.asarray(batch))
    got = np.asarray(seqops.base_composition_packed(words, 64))
    for b in range(4):
        assert got[b].tolist() == [
            int((batch[b] == c).sum()) for c in b"ACTG"
        ]


COMP_N = bytes.maketrans(b"ACGTN", b"TGCAN")


def _revcomp_n(seq: bytes) -> bytes:
    return seq.upper().replace(b"U", b"T").translate(COMP_N)[::-1]


@pytest.mark.parametrize(
    "n", [1, 2, 3, 26, 27, 28, 53, 54, 55, 81, 1000, 27 * 64]
)
def test_revcomp_packed_b5(rng, n):
    """Digit complement (d ^ 2 for d < 4, N fixed) + digit-order reversal on
    the packed 63-bit stream, bit-exact to re-encoding the byte revcomp."""
    s = rng.choice(np.frombuffer(b"ACGTUNacgtun", np.uint8), size=n)
    w64 = oracle.n_to_bits2_lut(s)
    w32 = jnp.asarray(spec.u64_to_u32_pairs(w64).reshape(-1))
    got = np.asarray(seqops.revcomp_packed_b5(w32, n))
    want64 = oracle.n_to_bits2_lut(np.frombuffer(_revcomp_n(bytes(s)), np.uint8))
    want = spec.u64_to_u32_pairs(want64).reshape(-1)
    assert got.shape == want.shape
    assert np.array_equal(got, want), (n, got[:4], want[:4])


def test_revcomp_packed_b5_involution(rng):
    """revcomp(revcomp(x)) == x on full words (the tail re-zeroes)."""
    n = 27 * 19
    s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n)
    w32 = jnp.asarray(
        spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(s)).reshape(-1)
    )
    once = seqops.revcomp_packed_b5(w32, n)
    twice = np.asarray(seqops.revcomp_packed_b5(once, n))
    assert np.array_equal(twice, np.asarray(w32))


def test_revcomp_packed_b5_rejects_bad_shapes():
    with pytest.raises(TypeError):
        seqops.revcomp_packed_b5(jnp.zeros((2, 2), jnp.uint32), 27)
    with pytest.raises(ValueError):
        seqops.revcomp_packed_b5(jnp.zeros(2, jnp.uint32), 28)


@pytest.mark.parametrize("n", [1, 26, 53, 54, 100, 541])
@pytest.mark.parametrize("slack", [1, 2, 5])
def test_revcomp_packed_b5_slack_capacity(rng, n, slack):
    """Streams with spare trailing u64 words (legal buffers) must revcomp
    exactly — the r05 review reproduced silent corruption here (delta
    went negative and src_triplet read the wrong word)."""
    s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n)
    w64 = np.concatenate(
        [oracle.n_to_bits2_lut(s), np.zeros(slack, np.uint64)]
    )
    w32 = jnp.asarray(spec.u64_to_u32_pairs(w64).reshape(-1))
    got = spec.u32_pairs_to_u64(np.asarray(seqops.revcomp_packed_b5(w32, n)))
    want = oracle.n_to_bits2_lut(np.frombuffer(_revcomp_n(bytes(s)), np.uint8))
    want = np.concatenate([want, np.zeros(len(w64) - len(want), np.uint64)])
    assert np.array_equal(got, want), (n, slack)


# ---------------------------------------------------------------------------
# Packed-domain region extraction / concatenation
# ---------------------------------------------------------------------------


def _enc2(seq: np.ndarray) -> np.ndarray:
    return spec.u64_to_u32_pairs(oracle.n_to_bits_lut(seq)).reshape(-1)


def _enc5(seq: np.ndarray) -> np.ndarray:
    return spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(seq)).reshape(-1)


def _norm2(seq: np.ndarray) -> np.ndarray:
    return oracle.bits_to_n_lut(oracle.n_to_bits_lut(seq), len(seq))


def _norm5(seq: np.ndarray) -> np.ndarray:
    return oracle.bits_to_n2_lut(oracle.n_to_bits2_lut(seq), len(seq))


@pytest.mark.parametrize(
    "start,n",
    [(0, 16), (0, 7), (5, 20), (16, 16), (31, 3), (33, 40), (-5, 12), (90, 20)],
)
def test_packed_slice_2bit(rng, start, n):
    """packed_slice == encode(decode(x)['A'-extended][start:start+n])."""
    s = rng.choice(np.frombuffer(b"ACGTacgtu", np.uint8), size=100)
    got = np.asarray(seqops.packed_slice(jnp.asarray(_enc2(s)), start, n))
    ext = np.full(200, ord("A"), np.uint8)
    ext[:100] = _norm2(s)
    win = ext[max(start, 0) : start + n]
    if start < 0:
        win = np.concatenate(
            [np.full(min(-start, n), ord("A"), np.uint8), win]
        )[:n]
    assert np.array_equal(got, _enc2(win))


@pytest.mark.parametrize(
    "start,n",
    [(0, 27), (0, 10), (3, 30), (7, 26), (26, 29), (54, 27), (-4, 9), (95, 30)],
)
def test_packed_slice_b5(rng, start, n):
    s = rng.choice(np.frombuffer(b"ACGTUNacgtun", np.uint8), size=100)
    got = np.asarray(seqops.packed_slice_b5(jnp.asarray(_enc5(s)), start, n))
    ext = np.full(200, ord("A"), np.uint8)
    ext[:100] = _norm5(s)
    win = ext[max(start, 0) : start + n]
    if start < 0:
        win = np.concatenate(
            [np.full(min(-start, n), ord("A"), np.uint8), win]
        )[:n]
    assert np.array_equal(got, _enc5(win))


def test_packed_slice_fuzz(rng):
    """Randomized (L, start, n) sweep, both codecs, incl. degenerate cases."""
    for _ in range(60):
        L = int(rng.integers(0, 150))
        start = int(rng.integers(-35, L + 35))
        n = int(rng.integers(0, 70))
        s2 = rng.choice(np.frombuffer(b"ACGTacgtu", np.uint8), size=L)
        s5 = rng.choice(np.frombuffer(b"ACGTUNacgtun", np.uint8), size=L)
        for s, enc, normf, op in (
            (s2, _enc2, _norm2, seqops.packed_slice),
            (s5, _enc5, _norm5, seqops.packed_slice_b5),
        ):
            ext = np.full(max(L, start + n, 1) + 40, ord("A"), np.uint8)
            if L:
                ext[:L] = normf(s)
            win = ext[max(start, 0) : start + n]
            if start < 0:
                win = np.concatenate(
                    [np.full(min(-start, n), ord("A"), np.uint8), win]
                )[:n]
            got = np.asarray(op(jnp.asarray(enc(s)), start, n))
            want = enc(win) if n else np.zeros(0, np.uint32)
            assert np.array_equal(got, want), (op.__name__, L, start, n)


@pytest.mark.parametrize("la,lb", [(0, 40), (40, 0), (32, 32), (17, 45), (3, 1)])
def test_packed_concat_2bit(rng, la, lb):
    a = rng.choice(np.frombuffer(b"ACGTacgtu", np.uint8), size=la)
    b = rng.choice(np.frombuffer(b"ACGTacgtu", np.uint8), size=lb)
    got = np.asarray(
        seqops.packed_concat(jnp.asarray(_enc2(a)), la, jnp.asarray(_enc2(b)), lb)
    )
    want = _enc2(np.concatenate([_norm2(a), _norm2(b)]).astype(np.uint8))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("la,lb", [(0, 30), (27, 27), (13, 41), (28, 2), (1, 1)])
def test_packed_concat_b5(rng, la, lb):
    a = rng.choice(np.frombuffer(b"ACGTUNacgtun", np.uint8), size=la)
    b = rng.choice(np.frombuffer(b"ACGTUNacgtun", np.uint8), size=lb)
    got = np.asarray(
        seqops.packed_concat_b5(
            jnp.asarray(_enc5(a)), la, jnp.asarray(_enc5(b)), lb
        )
    )
    want = _enc5(np.concatenate([_norm5(a), _norm5(b)]).astype(np.uint8))
    assert np.array_equal(got, want)


def test_packed_concat_fuzz(rng):
    """Randomized concat sweep; exercises the cross-lane digit carry (the
    boundary 7-bit chunk spanning a u32 pair) when it lands on triplet 4."""
    for _ in range(60):
        la = int(rng.integers(0, 120))
        lb = int(rng.integers(0, 120))
        for alpha, enc, normf, op in (
            (b"ACGTacgtu", _enc2, _norm2, seqops.packed_concat),
            (b"ACGTUNacgtun", _enc5, _norm5, seqops.packed_concat_b5),
        ):
            a = rng.choice(np.frombuffer(alpha, np.uint8), size=la)
            b = rng.choice(np.frombuffer(alpha, np.uint8), size=lb)
            got = np.asarray(op(jnp.asarray(enc(a)), la, jnp.asarray(enc(b)), lb))
            want = enc(np.concatenate([normf(a), normf(b)]).astype(np.uint8))
            assert np.array_equal(got, want), (op.__name__, la, lb)


def test_packed_slice_roundtrip_with_concat(rng):
    """concat(slice(x, 0, k), k, slice(x, k, n-k), n-k) == x."""
    n = 211
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    w = jnp.asarray(_enc2(s))
    for k in (0, 1, 16, 33, 100, n):
        left = seqops.packed_slice(w, 0, k)
        right = seqops.packed_slice(w, k, n - k)
        back = np.asarray(seqops.packed_concat(left, k, right, n - k))
        assert np.array_equal(back, np.asarray(w)), k
    w5 = jnp.asarray(_enc5(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n)))
    for k in (0, 2, 27, 55, 200, n):
        left = seqops.packed_slice_b5(w5, 0, k)
        right = seqops.packed_slice_b5(w5, k, n - k)
        back = np.asarray(seqops.packed_concat_b5(left, k, right, n - k))
        assert np.array_equal(back, np.asarray(w5)), k


# ---------------------------------------------------------------------------
# Packed-domain codon translation
# ---------------------------------------------------------------------------

_CODON_TABLE = {}


def _fill_codon_table():
    aas = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
    tcag = "TCAG"
    for i, aa in enumerate(aas):
        _CODON_TABLE[tcag[i >> 4] + tcag[(i >> 2) & 3] + tcag[i & 3]] = aa


_fill_codon_table()


def _naive_translate(seq: bytes, frame: int) -> bytes:
    s = seq.upper().replace(b"U", b"T").decode()
    return "".join(
        _CODON_TABLE[s[i : i + 3]]
        for i in range(frame, len(s) - 2, 3)
    ).encode()


def test_codon_table_spot_checks():
    # classic anchors: start, stops, tryptophan
    assert _CODON_TABLE["ATG"] == "M"
    assert _CODON_TABLE["TAA"] == _CODON_TABLE["TAG"] == _CODON_TABLE["TGA"] == "*"
    assert _CODON_TABLE["TGG"] == "W"
    assert _CODON_TABLE["GAT"] == "D" and _CODON_TABLE["AAA"] == "K"


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_translate_packed(rng, frame):
    for L in (3, 4, 5, 47, 96, 300):
        if (L - frame) // 3 <= 0:
            continue
        s = bytes(rng.choice(np.frombuffer(b"ACGTacgtu", np.uint8), size=L))
        w = jnp.asarray(
            spec.u64_to_u32_pairs(
                oracle.n_to_bits_lut(np.frombuffer(s, np.uint8))
            ).reshape(-1)
        )
        got = bytes(np.asarray(seqops.translate_packed(w, L, frame)))
        assert got == _naive_translate(s, frame), (L, frame)


def test_translate_6frame(rng):
    L = 101
    s = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L))
    w = jnp.asarray(
        spec.u64_to_u32_pairs(
            oracle.n_to_bits_lut(np.frombuffer(s, np.uint8))
        ).reshape(-1)
    )
    frames = seqops.translate_6frame(w, L)
    assert len(frames) == 6
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rc = s.translate(comp)[::-1]
    for f in range(3):
        assert bytes(np.asarray(frames[f])) == _naive_translate(s, f)
        assert bytes(np.asarray(frames[3 + f])) == _naive_translate(rc, f)


def test_translate_errors():
    w = jnp.zeros(2, jnp.uint32)
    with pytest.raises(ValueError):
        seqops.translate_packed(w, 2, 0)  # no whole codon
    with pytest.raises(ValueError):
        seqops.translate_packed(w, 9, 3)  # bad frame


def _naive_translate_n(seq: bytes, frame: int) -> bytes:
    s = seq.upper().replace(b"U", b"T").decode()
    out = []
    for i in range(frame, len(s) - 2, 3):
        cod = s[i : i + 3]
        out.append("X" if "N" in cod else _CODON_TABLE[cod])
    return "".join(out).encode()


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_translate_packed_b5(rng, frame):
    for L in (3, 4, 5, 27, 47, 96, 300):
        if (L - frame) // 3 <= 0:
            continue
        s = bytes(rng.choice(np.frombuffer(b"ACGTNacgtnu", np.uint8), size=L))
        w = jnp.asarray(
            spec.u64_to_u32_pairs(
                oracle.n_to_bits2_lut(np.frombuffer(s, np.uint8))
            ).reshape(-1)
        )
        got = bytes(np.asarray(seqops.translate_packed_b5(w, L, frame)))
        assert got == _naive_translate_n(s, frame), (L, frame)


def test_translate_6frame_b5(rng):
    L = 101
    s = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L))
    w = jnp.asarray(
        spec.u64_to_u32_pairs(
            oracle.n_to_bits2_lut(np.frombuffer(s, np.uint8))
        ).reshape(-1)
    )
    frames = seqops.translate_6frame_b5(w, L)
    assert len(frames) == 6
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    rc = s.translate(comp)[::-1]
    for f in range(3):
        assert bytes(np.asarray(frames[f])) == _naive_translate_n(s, f)
        assert bytes(np.asarray(frames[3 + f])) == _naive_translate_n(rc, f)


def test_translate_b5_agrees_with_2bit_on_n_free_input(rng):
    s = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=99))
    w2 = jnp.asarray(
        spec.u64_to_u32_pairs(
            oracle.n_to_bits_lut(np.frombuffer(s, np.uint8))
        ).reshape(-1)
    )
    w5 = jnp.asarray(
        spec.u64_to_u32_pairs(
            oracle.n_to_bits2_lut(np.frombuffer(s, np.uint8))
        ).reshape(-1)
    )
    for f in range(3):
        assert bytes(np.asarray(seqops.translate_packed(w2, 99, f))) == bytes(
            np.asarray(seqops.translate_packed_b5(w5, 99, f))
        )


def test_translate_b5_errors():
    w = jnp.zeros(2, jnp.uint32)
    with pytest.raises(ValueError):
        seqops.translate_packed_b5(w, 2, 0)
    with pytest.raises(ValueError):
        seqops.translate_packed_b5(w, 9, 3)
    with pytest.raises(ValueError):
        seqops.translate_packed_b5(w, 28, 0)  # exceeds one-word capacity


class TestDuplicateMask:
    def _pack_rows(self, seqs):
        from cute_nucleotides_jax.ops import oracle, spec

        lens = np.array([len(s) for s in seqs], np.int32)
        W = 2 * max(1, -(-int(lens.max()) // 32))
        rows = np.zeros((len(seqs), W), np.uint32)
        for i, s in enumerate(seqs):
            if s:
                v = spec.u64_to_u32_pairs(oracle.n_to_bits_lut(s)).reshape(-1)
                rows[i, : v.size] = v
        return rows, lens

    def test_vs_dict_oracle(self, rng):
        from cute_nucleotides_jax.ops import seqops

        pool = [
            bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(5, 60))).astype(np.uint8))
            for _ in range(12)
        ]
        seqs = [pool[int(rng.integers(0, len(pool)))] for _ in range(64)]
        rows, lens = self._pack_rows(seqs)
        got = np.asarray(seqops.duplicate_mask(rows, lens))
        seen = set()
        want = []
        for s in seqs:
            want.append(s in seen)
            seen.add(s)
        assert list(got) == want

    def test_case_and_padding_fold(self):
        from cute_nucleotides_jax.ops import seqops

        # 'acgu' encodes identically to 'ACGT'; a prefix is NOT a dup
        rows, lens = self._pack_rows([b"ACGT", b"acgu", b"ACG", b"ACGT"])
        got = np.asarray(seqops.duplicate_mask(rows, lens))
        assert list(got) == [False, True, False, True]

    def test_length_distinguishes_padded_equals(self):
        from cute_nucleotides_jax.ops import seqops

        # same packed words ('A' padding) but different lengths
        rows, lens = self._pack_rows([b"ACGTA", b"ACGT"])
        assert list(np.asarray(seqops.duplicate_mask(rows, lens))) == [
            False,
            False,
        ]


class TestGcBins:
    def test_vs_byte_oracle(self, rng):
        from cute_nucleotides_jax.ops import oracle, seqops, spec

        L = 5000
        s = rng.choice(np.frombuffer(b"ACGTacgtu", np.uint8), size=L)
        w = spec.u64_to_u32_pairs(oracle.n_to_bits_lut(s)).reshape(-1)
        for bin_nt in (16, 64, 1024):
            got = np.asarray(seqops.gc_bins_packed(w, bin_nt=bin_nt))
            folded = np.frombuffer(
                bytes(s).upper().replace(b"U", b"T"), np.uint8
            )
            gc = (folded == ord("G")) | (folded == ord("C"))
            nb = -(-16 * w.size // bin_nt)
            want = np.zeros(nb, np.int64)
            for i in range(L):
                want[i // bin_nt] += gc[i]
            assert got.shape == (nb,)
            np.testing.assert_array_equal(got, want)

    def test_batched_and_guard(self, rng):
        from cute_nucleotides_jax.ops import seqops

        rows = rng.integers(0, 2**32, (4, 8), dtype=np.uint64).astype(
            np.uint32
        )
        out = np.asarray(seqops.gc_bins_packed(rows, bin_nt=32))
        assert out.shape == (4, 4)
        assert out.sum() == np.asarray(
            seqops.gc_content_packed(rows)
        ).sum()
        import pytest as _pytest

        with _pytest.raises(ValueError):
            seqops.gc_bins_packed(rows, bin_nt=24)
