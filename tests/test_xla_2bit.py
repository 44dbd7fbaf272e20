"""2-bit XLA codec kernels vs the NumPy oracle at panel and batch widths.

Pins every encode/decode variant and the checked encode bit-exactly to the
oracle on randomized, mixed-case inputs across multi-row panels, ragged row
counts and every byte value (SURVEY.md §4 strategy).  The same programs run
on the accelerator in ``chip_smoke.py``'s kernels phase at full width.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cute_nucleotides_jax.ops import oracle, spec, xla

ALPHABET = np.frombuffer(b"ACGTUacgtu", dtype=np.uint8)


def _rand_seq(rng, n, alphabet=ALPHABET):
    return rng.choice(alphabet, size=n)


def _normalized(batch: np.ndarray) -> np.ndarray:
    return np.frombuffer(
        bytes(batch.tobytes().upper()).replace(b"U", b"T"), dtype=np.uint8
    ).reshape(batch.shape)


@pytest.mark.parametrize("variant", xla.ENCODE_2BIT_VARIANTS)
def test_encode_2bit_panel_matches_oracle(rng, variant):
    s = _rand_seq(rng, 8 * 2048)
    words = np.asarray(xla.encode_2bit_words(jnp.asarray(s.reshape(8, 2048)), variant))
    got = spec.u32_pairs_to_u64(np.ascontiguousarray(words.reshape(-1)))
    assert np.array_equal(got, oracle.n_to_bits_lut(s))


@pytest.mark.parametrize("variant", xla.DECODE_2BIT_VARIANTS)
def test_decode_2bit_panel_matches_oracle(rng, variant):
    n = 8 * 2048
    s = _rand_seq(rng, n)
    words = oracle.n_to_bits_lut(s)
    w32 = spec.u64_to_u32_pairs(words).reshape(8, -1)
    got = np.asarray(xla.decode_2bit_bytes(jnp.asarray(w32), variant))
    assert np.array_equal(got.reshape(-1), oracle.bits_to_n_lut(words, n))


@pytest.mark.parametrize("variant", xla.ENCODE_2BIT_VARIANTS)
def test_encode_2bit_words_batch(rng, variant):
    B, L = 4, 160
    batch = _rand_seq(rng, B * L).reshape(B, L)
    out = np.asarray(xla.encode_2bit_words(jnp.asarray(batch), variant))
    for b in range(B):
        want = oracle.n_to_bits_lut(batch[b])
        assert np.array_equal(spec.u32_pairs_to_u64(out[b]), want)


def test_decode_2bit_bytes_roundtrip(rng):
    B, L = 4, 320
    batch = _rand_seq(rng, B * L).reshape(B, L)
    words = xla.encode_2bit_words(jnp.asarray(batch))
    back = np.asarray(xla.decode_2bit_bytes(words))
    assert np.array_equal(back, _normalized(batch))


def test_ragged_rows(rng):
    # an odd row count: no row may leak into another
    s = _rand_seq(rng, 3 * 2048)
    words = np.asarray(xla.encode_2bit_words(jnp.asarray(s.reshape(3, 2048))))
    got = spec.u32_pairs_to_u64(np.ascontiguousarray(words.reshape(-1)))
    assert np.array_equal(got, oracle.n_to_bits_lut(s))


def test_encode_2bit_dot_variant_wide(rng):
    s = _rand_seq(rng, 8 * 8192)
    words = np.asarray(xla.encode_2bit_words(jnp.asarray(s.reshape(8, 8192)), "dot"))
    got = spec.u32_pairs_to_u64(np.ascontiguousarray(words.reshape(-1)))
    assert np.array_equal(got, oracle.n_to_bits_lut(s))


def test_encode_2bit_dot_ragged_widths(rng):
    """The weighted-sum pack at widths that are not multiples of 512."""
    for L in (64, 2048, 8192, 2048 * 3, 32 * 33):
        s = rng.choice(ALPHABET, size=(3, L))
        got = np.asarray(xla.encode_2bit_words(jnp.asarray(s), "dot"))
        want = np.stack([oracle.n_to_bits_lut(row) for row in s])
        assert np.array_equal(
            spec.u32_pairs_to_u64(np.ascontiguousarray(got.reshape(-1))),
            want.reshape(-1),
        ), L


def test_encode_2bit_checked_valid_input(rng):
    s = _rand_seq(rng, 8 * 2048).reshape(8, 2048)
    words, bad = xla.encode_2bit_words_checked(jnp.asarray(s), "mul")
    ref = np.asarray(xla.encode_2bit_words(jnp.asarray(s), "mul"))
    assert np.array_equal(np.asarray(words), ref)
    assert not np.asarray(bad).any()


@pytest.mark.parametrize("bad_byte", [ord("N"), ord("X"), 0, 0x80, 0xFF, ord("B")])
def test_encode_2bit_checked_flags_bad_rows(rng, bad_byte):
    s = _rand_seq(rng, 8 * 2048).reshape(8, -1)
    s[3, 777] = bad_byte
    s[6, 0] = bad_byte
    _, bad = xla.encode_2bit_words_checked(jnp.asarray(s), "mul")
    assert list(np.nonzero(np.asarray(bad))[0]) == [3, 6]


def test_encode_2bit_checked_all_bytes_exact():
    # every byte value 0..255 in each of the 4 byte positions of a lane
    s = np.full((8, 512 * 4), ord("A"), np.uint8)
    vals = np.arange(256, dtype=np.uint8)
    valid = np.frombuffer(b"ACGTUacgtu", np.uint8)
    for pos in range(4):
        s[pos % 8, pos * 256 : (pos + 1) * 256] = vals
    _, bad = xla.encode_2bit_words_checked(jnp.asarray(s), "mul")
    want = np.array([np.any(~np.isin(row, valid)) for row in s])
    assert np.array_equal(np.asarray(bad), want)


def test_encode_2bit_words_checked_flags(rng):
    s = _rand_seq(rng, 3 * 1024).reshape(3, 1024)
    s[1, 500] = ord("Z")
    words, bad = xla.encode_2bit_words_checked(jnp.asarray(s), "shift")
    ref = np.asarray(xla.encode_2bit_words(jnp.asarray(s), "shift"))
    assert np.array_equal(np.asarray(words), ref)
    assert list(np.asarray(bad)) == [False, True, False]
