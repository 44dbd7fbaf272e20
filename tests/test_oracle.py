"""Golden-vector and property tests for the NumPy oracle tier.

The hardcoded expected words are the bit-exactness contract, taken from the
reference's inline unit tests (reference src/n_to_bits.rs:408-470 and
src/n_to_bits2.rs:270-299).  Every other tier in this framework is tested
against the oracle, so these constants anchor the whole build.
"""

import numpy as np
import pytest

from cute_nucleotides_jax.ops import oracle, spec

GOLDEN_2BIT_32 = np.array(
    [0b1101100011011000110110001101100011011000110110001101100011011000],
    dtype=np.uint64,
)
GOLDEN_2BIT_4 = np.array([0b11011000], dtype=np.uint64)
GOLDEN_B5_35 = np.array(
    [
        0b11011010100100010111010001111101000110110101001000101110100011,
        0b1011101000111110100,
    ],
    dtype=np.uint64,
)
GOLDEN_B5_5 = np.array([0b101110100011], dtype=np.uint64)

SEQ32 = b"ATCGATCGATCGATCGATCGATCGATCGATCG"
SEQ35 = b"ATCGNATCGNATCGNATCGNATCGNATCGNATCGN"


class TestGoldenVectors:
    def test_n_to_bits_lut(self):
        np.testing.assert_array_equal(oracle.n_to_bits_lut(SEQ32), GOLDEN_2BIT_32)
        np.testing.assert_array_equal(oracle.n_to_bits_lut(b"ATCG"), GOLDEN_2BIT_4)

    def test_bits_to_n_lut(self):
        assert bytes(oracle.bits_to_n_lut(GOLDEN_2BIT_32, 32)) == SEQ32

    def test_n_to_bits2_lut(self):
        np.testing.assert_array_equal(oracle.n_to_bits2_lut(SEQ35), GOLDEN_B5_35)
        np.testing.assert_array_equal(oracle.n_to_bits2_lut(b"ATCGN"), GOLDEN_B5_5)

    def test_bits_to_n2_lut(self):
        assert bytes(oracle.bits_to_n2_lut(GOLDEN_B5_35, 35)) == SEQ35


class TestProperties:
    @pytest.mark.parametrize("n", [0, 1, 4, 31, 32, 33, 63, 64, 65, 100])
    def test_roundtrip_2bit(self, rng, n):
        seq = rng.choice(np.frombuffer(b"ACGTUacgtu", dtype=np.uint8), size=n)
        enc = oracle.n_to_bits_lut(seq)
        assert enc.size == spec.num_words_2bit(n)
        dec = oracle.bits_to_n_lut(enc, n)
        expected = np.char.upper(seq.view("S1")).view(np.uint8).copy()
        expected[expected == ord("U")] = ord("T")
        np.testing.assert_array_equal(dec, expected)

    @pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 26, 27, 28, 53, 54, 55, 80])
    def test_roundtrip_b5(self, rng, n):
        seq = rng.choice(np.frombuffer(b"ACGTUNacgtun", dtype=np.uint8), size=n)
        enc = oracle.n_to_bits2_lut(seq)
        assert enc.size == spec.num_words_b5(n)
        dec = oracle.bits_to_n2_lut(enc, n)
        expected = np.char.upper(seq.view("S1")).view(np.uint8).copy()
        expected[expected == ord("U")] = ord("T")
        np.testing.assert_array_equal(dec, expected)

    def test_case_insensitive(self):
        np.testing.assert_array_equal(
            oracle.n_to_bits_lut(b"atcgatcg"), oracle.n_to_bits_lut(b"ATCGATCG")
        )
        np.testing.assert_array_equal(
            oracle.n_to_bits2_lut(b"atcgnatcgn"), oracle.n_to_bits2_lut(b"ATCGNATCGN")
        )

    def test_u_encodes_as_t(self):
        np.testing.assert_array_equal(
            oracle.n_to_bits_lut(b"AUCG"), oracle.n_to_bits_lut(b"ATCG")
        )
        np.testing.assert_array_equal(
            oracle.n_to_bits2_lut(b"AUCGN"), oracle.n_to_bits2_lut(b"ATCGN")
        )

    def test_unused_high_bits_zero(self, rng):
        seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=33)
        enc = oracle.n_to_bits_lut(seq)
        assert int(enc[-1]) >> 2 == 0
        seq5 = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=28)
        enc5 = oracle.n_to_bits2_lut(seq5)
        assert int(enc5[-1]) >> 7 == 0

    def test_decode_length_overflow_raises(self):
        with pytest.raises(ValueError):
            oracle.bits_to_n_lut(GOLDEN_2BIT_32, 33)
        with pytest.raises(ValueError):
            oracle.bits_to_n2_lut(GOLDEN_B5_5, 28)

    def test_u32_pair_serialization(self):
        enc = oracle.n_to_bits2_lut(SEQ35)
        pairs = spec.u64_to_u32_pairs(enc)
        assert pairs.shape == (2, 2)
        np.testing.assert_array_equal(spec.u32_pairs_to_u64(pairs.reshape(4)), enc)
