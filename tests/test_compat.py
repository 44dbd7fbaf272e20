"""Reference-name compatibility surface: all 12 names, reference semantics.

Mirrors the reference's own inline test style (src/n_to_bits.rs:408-470,
src/n_to_bits2.rs:270-299): every variant asserted against the same golden
constants, plus sub-block inputs exercising tail handling.
"""

import numpy as np
import pytest

from cute_nucleotides_jax import compat

GOLDEN_32 = [0b1101100011011000110110001101100011011000110110001101100011011000]
GOLDEN_4 = [0b11011000]
GOLDEN_B5 = [
    0b11011010100100010111010001111101000110110101001000101110100011,
    0b1011101000111110100,
]

ENCODERS = [
    compat.n_to_bits_lut,
    compat.n_to_bits_pext,
    compat.n_to_bits_shift,
    compat.n_to_bits_movemask,
    compat.n_to_bits_mul,
]
DECODERS = [
    compat.bits_to_n_lut,
    compat.bits_to_n_shuffle,
    compat.bits_to_n_pdep,
    compat.bits_to_n_clmul,
]


@pytest.mark.parametrize("enc", ENCODERS)
def test_encoders_golden(enc):
    # reference src/n_to_bits.rs golden vectors: full word + sub-block tail
    assert enc(b"ATCG" * 8).tolist() == GOLDEN_32
    assert enc(b"ATCG").tolist() == GOLDEN_4


@pytest.mark.parametrize("dec", DECODERS)
def test_decoders_golden(dec):
    got = dec(np.array(GOLDEN_32, dtype=np.uint64), 32)
    assert bytes(got) == b"ATCG" * 8
    got4 = dec(np.array(GOLDEN_4, dtype=np.uint64), 4)
    assert bytes(got4) == b"ATCG"


def test_b5_golden():
    # reference src/n_to_bits2.rs:275-279 (35 nt -> two words)
    for enc in (compat.n_to_bits2_lut, compat.n_to_bits2_pext):
        assert enc(b"ATCGN" * 7).tolist() == GOLDEN_B5
    for dec in (compat.bits_to_n2_lut, compat.bits_to_n2_pdep):
        got = dec(np.array(GOLDEN_B5, dtype=np.uint64), 35)
        assert bytes(got) == b"ATCGN" * 7


def test_decoder_length_panic_analogue():
    for dec in DECODERS:
        with pytest.raises(ValueError):
            dec(np.zeros(1, np.uint64), 33)
    for dec in (compat.bits_to_n2_lut, compat.bits_to_n2_pdep):
        with pytest.raises(ValueError):
            dec(np.zeros(1, np.uint64), 28)
