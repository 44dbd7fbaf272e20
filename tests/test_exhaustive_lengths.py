"""Exhaustive length/mod coverage (SURVEY §4a): every residue class.

Every length 1..96 covers each residue mod 32 three times (and mod 16 six
times); 1..81 covers each residue mod 27 three times.  The XLA tier runs the
full sweep; the "auto" tier samples the word boundaries where tail handling
changes shape.
"""

import numpy as np
import pytest

from cute_nucleotides_jax import api
from cute_nucleotides_jax.ops import oracle

ALPHA = np.frombuffer(b"ACGTUacgtu", dtype=np.uint8)
ALPHA_N = np.frombuffer(b"ACGTUNacgtun", dtype=np.uint8)


def test_all_lengths_2bit_xla(rng):
    for n in range(1, 97):
        s = rng.choice(ALPHA, size=n)
        w = api.n_to_bits(s, tier="xla")
        assert np.array_equal(w, oracle.n_to_bits_lut(s)), n
        back = api.bits_to_n(w, n, tier="xla")
        assert np.array_equal(back, oracle.bits_to_n_lut(w, n)), n


def test_all_lengths_b5_xla(rng):
    for n in range(1, 82):
        s = rng.choice(ALPHA_N, size=n)
        w = api.n_to_bits2(s, tier="xla")
        assert np.array_equal(w, oracle.n_to_bits2_lut(s)), n
        back = api.bits_to_n2(w, n, tier="xla")
        assert np.array_equal(back, oracle.bits_to_n2_lut(w, n)), n


@pytest.mark.parametrize("n", [15, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64, 65])
def test_word_boundaries_2bit_auto(rng, n):
    s = rng.choice(ALPHA, size=n)
    w = api.n_to_bits(s, tier="auto")
    assert np.array_equal(w, oracle.n_to_bits_lut(s)), n
    back = api.bits_to_n(w, n, tier="auto")
    assert np.array_equal(back, oracle.bits_to_n_lut(w, n)), n


@pytest.mark.parametrize("n", [26, 27, 28, 53, 54, 55, 80, 81])
def test_word_boundaries_b5_auto(rng, n):
    s = rng.choice(ALPHA_N, size=n)
    w = api.n_to_bits2(s, tier="auto")
    assert np.array_equal(w, oracle.n_to_bits2_lut(s)), n
    back = api.bits_to_n2(w, n, tier="auto")
    assert np.array_equal(back, oracle.bits_to_n2_lut(w, n)), n


def test_cross_variant_differential_fuzz(rng):
    """Every encode variant x every decode variant must agree bit-for-bit
    on random data at random lengths (regression net for new variants: one
    reference stream, many mechanisms)."""
    import jax.numpy as jnp

    from cute_nucleotides_jax.ops import oracle, xla

    for _ in range(6):
        n = int(rng.integers(1, 2000))
        s = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=n)
        pad = (-n) % 512  # cover every variant's block granularity
        x = np.concatenate([s, np.full(pad, ord("A"), np.uint8)])
        want = oracle.n_to_bits_lut(x)
        xd = jnp.asarray(x.reshape(1, -1))
        streams = {}
        for v in xla.ENCODE_2BIT_VARIANTS:
            streams[f"xla:{v}"] = np.asarray(
                xla.encode_2bit_words(xd, v)
            ).reshape(-1)
        streams["xla:checked"] = np.asarray(
            xla.encode_2bit_words_checked(xd)[0]
        ).reshape(-1)
        want32 = np.ascontiguousarray(want).view("<u4")
        for name, got in streams.items():
            assert np.array_equal(got, want32), (name, n)
        # decode every stream back with every decoder
        w = jnp.asarray(want32.reshape(1, -1))
        want_seq = oracle.bits_to_n_lut(want, x.size)
        for v in xla.DECODE_2BIT_VARIANTS:
            got = np.asarray(xla.decode_2bit_bytes(w, v)).reshape(-1)
            assert np.array_equal(got, want_seq), (f"xla:{v}", n)
        w2 = jnp.asarray(want32.reshape(2, -1)) if want32.size % 2 == 0 else w
        for v in xla.DECODE_2BIT_VARIANTS:
            got = np.asarray(xla.decode_2bit_bytes(w2, v)).reshape(-1)
            assert np.array_equal(got, want_seq), (f"xla:{v}:2-row", n)
