"""Base-5 XLA codec kernels vs the NumPy oracle at panel and batch widths.

Pins the integer triplet encoder, the multiply-shift decoder, the checked
forms and the packed GC count bit-exactly to the oracle (reference layout
src/n_to_bits2.rs:44-53) across multi-row, mixed-case, full-alphabet and
arbitrary-byte inputs.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cute_nucleotides_jax import models
from cute_nucleotides_jax.ops import oracle, seqops, spec, validate, xla

ALPHABET = np.frombuffer(b"ACGTUNacgtun", dtype=np.uint8)
ROW_NT = 3456  # 128 words per row


def _inter(words: np.ndarray, rows: int) -> np.ndarray:
    """u64 words -> interleaved u32 rows (the device word layout)."""
    return np.ascontiguousarray(words).view("<u4").reshape(rows, -1).copy()


@pytest.mark.parametrize("n", [27, 108, 3456, 3456 + 27, 2 * 3456 + 27 * 11])
def test_encode_b5_matches_oracle(rng, n):
    s = rng.choice(ALPHABET, size=n)
    got = np.asarray(xla.encode_b5_words(jnp.asarray(s)))
    assert np.array_equal(spec.u32_pairs_to_u64(got), oracle.n_to_bits2_lut(s))


def test_encode_b5_batch(rng):
    b = rng.choice(ALPHABET, size=(5, 135))
    got = np.asarray(xla.encode_b5_words(jnp.asarray(b)))
    for i in range(5):
        assert np.array_equal(
            spec.u32_pairs_to_u64(got[i]), oracle.n_to_bits2_lut(b[i])
        )


def test_encode_b5_arbitrary_bytes(rng):
    # defined out-of-alphabet behavior: all tiers agree (spec.py contract)
    s = rng.integers(0, 256, size=27 * 40, dtype=np.int64).astype(np.uint8)
    got = np.asarray(xla.encode_b5_words(jnp.asarray(s)))
    assert np.array_equal(spec.u32_pairs_to_u64(got), oracle.n_to_bits2_lut(s))


@pytest.mark.parametrize("n", [27, 3456, 3456 + 27 * 9])
def test_decode_b5_matches_oracle(rng, n):
    s = rng.choice(ALPHABET, size=n)
    words = oracle.n_to_bits2_lut(s)
    w32 = jnp.asarray(spec.u64_to_u32_pairs(words).reshape(-1))
    got = np.asarray(xla.decode_b5_bytes(w32))
    assert np.array_equal(got[:n], oracle.bits_to_n2_lut(words, n))


def test_b5_roundtrip_batch(rng):
    b = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(4, 216))
    w = xla.encode_b5_words(jnp.asarray(b))
    back = np.asarray(xla.decode_b5_bytes(w))
    assert np.array_equal(back, b)


def test_b5_golden_vector():
    # reference src/n_to_bits2.rs:275-279 (35 nt -> two words)
    s = np.frombuffer(b"ATCGN" * 7, np.uint8)
    padded = np.concatenate([s, np.full(54 - 35, ord("A"), np.uint8)])
    got = spec.u32_pairs_to_u64(np.asarray(xla.encode_b5_words(jnp.asarray(padded))))
    # 'A' padding to a word multiple must not change the words' bits
    want = oracle.n_to_bits2_lut(s)
    assert got[0] == want[0]
    assert got[1] == want[1]


@pytest.mark.parametrize("n_rows", [1, 3])
def test_encode_b5_rows_match_oracle(rng, n_rows):
    s = rng.choice(ALPHABET, size=n_rows * ROW_NT)
    got = np.asarray(xla.encode_b5_words(jnp.asarray(s.reshape(n_rows, ROW_NT))))
    assert np.array_equal(
        spec.u32_pairs_to_u64(np.ascontiguousarray(got.reshape(-1))),
        oracle.n_to_bits2_lut(s),
    )


def test_encode_b5_rows_feed_decoder(rng):
    s = rng.choice(ALPHABET, size=2 * ROW_NT)
    w = xla.encode_b5_words(jnp.asarray(s.reshape(2, ROW_NT)))
    back = np.asarray(xla.decode_b5_bytes(w))
    want = oracle.bits_to_n2_lut(oracle.n_to_bits2_lut(s), s.size)
    assert np.array_equal(back.reshape(-1), want)


def test_decode_b5_rows_match_oracle(rng):
    s = rng.choice(ALPHABET, size=2 * ROW_NT)
    words = oracle.n_to_bits2_lut(s)
    out = np.asarray(xla.decode_b5_bytes(jnp.asarray(_inter(words, 2))))
    assert out.shape == (2, ROW_NT)
    assert np.array_equal(out.reshape(-1), oracle.bits_to_n2_lut(words, s.size))


def test_decode_b5_full_width_row(rng):
    """The resident-batch row width (8208 nt = 304 words)."""
    s = rng.choice(ALPHABET, size=2 * 8208)
    words = oracle.n_to_bits2_lut(s)
    out = np.asarray(xla.decode_b5_bytes(jnp.asarray(_inter(words, 2))))
    assert np.array_equal(out.reshape(-1), oracle.bits_to_n2_lut(words, s.size))


def test_decode_b5_interleaved_matches_oracle(rng):
    s = rng.choice(ALPHABET, size=3 * ROW_NT)
    words = oracle.n_to_bits2_lut(s)  # u64[384]
    out = np.asarray(xla.decode_b5_bytes(jnp.asarray(_inter(words, 3))))
    assert np.array_equal(out.reshape(-1), oracle.bits_to_n2_lut(words, s.size))


def test_decode_b5_digit_alphabet(rng):
    """Every decoded byte is one of the five canonical letters, and the
    digit of each letter round-trips through the encoder's LUT."""
    s = rng.choice(ALPHABET, size=2 * ROW_NT)
    words = oracle.n_to_bits2_lut(s)
    out = np.asarray(xla.decode_b5_bytes(jnp.asarray(_inter(words, 2))))
    assert set(np.unique(out).tolist()) <= set(b"ACGTN")
    digits = spec.DIGIT_LUT8[out & 7]
    assert np.array_equal(spec.DIG_TO_CHAR_B5[digits], out)


def test_encode_b5_checked_parity_and_flags(rng):
    R = 16
    alpha = np.frombuffer(b"ATCGNatcgnu", dtype=np.uint8)
    x = rng.choice(alpha, size=(R, ROW_NT)).astype(np.uint8)
    out, bad = xla.encode_b5_words_checked(jnp.asarray(x))
    ref = np.asarray(xla.encode_b5_words(jnp.asarray(x)))
    assert np.array_equal(np.asarray(out), ref)
    assert not bool(bad)
    # bytes that alias valid digits via &7 must still flag, row by row
    for r, c, b in [(0, 0, ord("F")), (5, 3455, 0x00), (9, 1000, 0xC1), (12, 7, ord("Q"))]:
        y = x.copy()
        y[r, c] = b
        _, bad = xla.encode_b5_words_checked(jnp.asarray(y))
        assert bool(bad), (r, c, b)


def test_encode_b5_words_checked_scalar_flag(rng):
    s = rng.choice(np.frombuffer(b"ATCGN", np.uint8), size=27 * 100)
    words, bad = xla.encode_b5_words_checked(jnp.asarray(s))
    ref = np.asarray(xla.encode_b5_words(jnp.asarray(s)))
    assert np.array_equal(np.asarray(words), ref)
    assert not bool(bad)
    s[1234] = ord("E")
    _, bad = xla.encode_b5_words_checked(jnp.asarray(s))
    assert bool(bad)


def test_b5_checked_encode_accept_set_exhaustive():
    """The checked encode accepts exactly ops.validate's allow_n set on all
    256 byte values, and its words equal the unchecked encoder's."""
    import jax

    x = np.full((256, 27), ord("A"), np.uint8)
    x[:, 13] = np.arange(256, dtype=np.uint8)  # one byte value per row
    w, bad = jax.vmap(xla.encode_b5_words_checked)(jnp.asarray(x))
    want = ~np.asarray(
        validate.valid_mask(jnp.arange(256, dtype=jnp.uint8), allow_n=True)
    )
    assert np.array_equal(np.asarray(bad), want)
    assert np.array_equal(np.asarray(w), np.asarray(xla.encode_b5_words(jnp.asarray(x))))


def test_decode_b5_checked_parity_and_flags(rng):
    """The checked decode: bytes bit-exact to the unchecked decode, the flag
    set exactly when a u64 word is corrupt (triplet >= 125 or pad bit 63)
    — first_invalid_word_b5's semantics."""
    R = 8
    s = rng.choice(ALPHABET, size=R * ROW_NT)
    words = oracle.n_to_bits2_lut(s)
    inter = _inter(words, R)
    checked = models._jit_decode_b5_checked()
    out, bad = checked(jnp.asarray(inter))
    ref = np.asarray(xla.decode_b5_bytes(jnp.asarray(inter)))
    assert np.array_equal(np.asarray(out), ref)
    assert not bool(bad)
    corrupt = []
    c = inter.copy()
    c[1, 6] = (c[1, 6] & ~np.uint32(0x7F)) | np.uint32(125)  # triplet 0 -> 125
    corrupt.append(c)
    c = inter.copy()
    c[4, 2 * 77 + 1] |= np.uint32(0x7F) << (7 * 8 - 32)  # triplet 8 -> 127
    corrupt.append(c)
    c = inter.copy()
    c[6, 2 * 10 + 1] |= np.uint32(1) << 31  # pad bit 63
    corrupt.append(c)
    for c in corrupt:
        assert bool(checked(jnp.asarray(c))[1])
    # boundary: the largest VALID triplet (124) must not flag
    c = inter.copy()
    c[0, 0] = (c[0, 0] & ~np.uint32(0x7F)) | np.uint32(124)
    assert not bool(checked(jnp.asarray(c))[1])


def test_decode_b5_bytes_checked_scalar_flag(rng):
    s = rng.choice(np.frombuffer(b"ATCGN", np.uint8), size=27 * 100 + 13)
    w64 = oracle.n_to_bits2_lut(s)
    w = spec.u64_to_u32_pairs(w64).reshape(-1)
    out, bad = models.Base5Codec().decode_checked(jnp.asarray(w))
    assert np.array_equal(np.asarray(out)[: s.size], oracle.bits_to_n2_lut(w64, s.size))
    assert not bool(bad)
    wbad = w.copy()
    wbad[11] |= np.uint32(1) << 31  # word 5 pad bit
    _, bad = models.Base5Codec().decode_checked(jnp.asarray(wbad))
    assert bool(bad)


# --- GC content on the packed base-5 stream ----------------------------------


def _count_gc(s: np.ndarray) -> int:
    return int(np.sum(np.isin(s, np.frombuffer(b"CGcg", np.uint8))))


@pytest.mark.parametrize("n", [27, 500, 3456, 3457, 8208, 3456 * 3 + 5])
def test_gc_b5_stream_matches_byte_count(rng, n):
    s = rng.choice(ALPHABET, size=n)
    w32 = jnp.asarray(spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(s)).reshape(-1))
    assert int(seqops.gc_content_packed_b5(w32)) == _count_gc(s)


def test_gc_b5_row_sums(rng):
    # 2-D input: per-row counts match the byte-domain count row by row
    R = 4
    s = rng.choice(ALPHABET, size=(R, ROW_NT))
    rows = np.stack(
        [spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(s[i])).reshape(-1) for i in range(R)]
    )
    got = np.asarray(seqops.gc_content_packed_b5(jnp.asarray(rows)))
    assert np.array_equal(got, [_count_gc(s[i]) for i in range(R)])


def test_gc_b5_short_and_long_streams_agree(rng):
    # the sizes on both sides of the former 1024-word kernel threshold
    for n in (513, 27 * 1024):
        s = rng.choice(ALPHABET, size=n)
        w32 = jnp.asarray(spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(s)).reshape(-1))
        assert int(seqops.gc_content_packed_b5(w32)) == _count_gc(s)
