"""Parity tests: XLA whole-array tier vs the NumPy oracle.

Randomized strings cover all lengths mod 32 / mod 27 boundaries, mixed case,
U, and the full byte range (out-of-alphabet behavior is *defined* in this
framework — spec.py — so kernels and oracle must agree on all 256 bytes).
"""

import numpy as np
import pytest

from cute_nucleotides_jax import api
from cute_nucleotides_jax.ops import oracle

from test_oracle import GOLDEN_2BIT_32, GOLDEN_B5_35, SEQ32, SEQ35

ALPHABET = np.frombuffer(b"ACGTUNacgtun", dtype=np.uint8)


class TestGoldenVectors:
    @pytest.mark.parametrize("variant", ["shift", "mul", "interleave", "dot"])
    def test_encode_2bit(self, variant):
        np.testing.assert_array_equal(
            api.n_to_bits(SEQ32, tier="xla", variant=variant), GOLDEN_2BIT_32
        )
        np.testing.assert_array_equal(
            api.n_to_bits(b"ATCG", tier="xla", variant=variant),
            np.array([0b11011000], dtype=np.uint64),
        )

    @pytest.mark.parametrize("variant", ["shuffle", "select", "swar", "broadcast"])
    def test_decode_2bit(self, variant):
        assert bytes(api.bits_to_n(GOLDEN_2BIT_32, 32, variant=variant)) == SEQ32

    def test_encode_b5(self):
        np.testing.assert_array_equal(api.n_to_bits2(SEQ35), GOLDEN_B5_35)
        np.testing.assert_array_equal(
            api.n_to_bits2(b"ATCGN"), np.array([0b101110100011], dtype=np.uint64)
        )

    def test_decode_b5(self):
        assert bytes(api.bits_to_n2(GOLDEN_B5_35, 35)) == SEQ35


class TestOracleParity:
    @pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 257])
    @pytest.mark.parametrize("variant", ["shift", "mul", "interleave", "dot"])
    def test_encode_2bit_parity(self, rng, n, variant):
        seq = rng.choice(ALPHABET, size=n)
        np.testing.assert_array_equal(
            api.n_to_bits(seq, variant=variant), oracle.n_to_bits_lut(seq)
        )

    @pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100])
    @pytest.mark.parametrize("variant", ["shuffle", "select", "swar", "broadcast"])
    def test_decode_2bit_parity(self, rng, n, variant):
        seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n)
        enc = oracle.n_to_bits_lut(seq)
        np.testing.assert_array_equal(
            api.bits_to_n(enc, n, variant=variant), oracle.bits_to_n_lut(enc, n)
        )

    @pytest.mark.parametrize("n", [0, 1, 2, 3, 26, 27, 28, 53, 54, 55, 108, 109])
    def test_b5_parity(self, rng, n):
        seq = rng.choice(ALPHABET, size=n)
        enc = api.n_to_bits2(seq)
        np.testing.assert_array_equal(enc, oracle.n_to_bits2_lut(seq))
        np.testing.assert_array_equal(
            api.bits_to_n2(enc, n), oracle.bits_to_n2_lut(enc, n)
        )

    def test_all_byte_values_2bit(self):
        seq = np.arange(256, dtype=np.uint8)
        np.testing.assert_array_equal(api.n_to_bits(seq), oracle.n_to_bits_lut(seq))

    def test_all_byte_values_b5(self):
        seq = np.arange(256, dtype=np.uint8)
        np.testing.assert_array_equal(api.n_to_bits2(seq), oracle.n_to_bits2_lut(seq))

    def test_all_triplet_values_b5_decode(self):
        # every possible 7-bit triplet value 0..124 must decode exactly
        # (exercises the multiply-shift div/mod over its whole domain)
        words = np.zeros(125, dtype=np.uint64)
        for v in range(125):
            words[v] = v  # triplet 0 carries the value
        n = 125 * 27
        np.testing.assert_array_equal(
            api.bits_to_n2(words, n), oracle.bits_to_n2_lut(words, n)
        )

    def test_roundtrip_long_random(self, rng):
        n = 40_000
        seq = rng.choice(ALPHABET, size=n)
        dec = api.bits_to_n(api.n_to_bits(seq), n)
        expected = np.char.upper(seq.view("S1")).view(np.uint8).copy()
        expected[expected == ord("U")] = ord("T")
        # out-of-alphabet N decodes as G in the 2-bit codec (defined behavior)
        expected[(expected == ord("N"))] = ord("G")
        np.testing.assert_array_equal(dec, expected)

    def test_overflow_raises(self):
        with pytest.raises(ValueError):
            api.bits_to_n(GOLDEN_2BIT_32, 33)
        with pytest.raises(ValueError):
            api.bits_to_n2(GOLDEN_B5_35, 55)
