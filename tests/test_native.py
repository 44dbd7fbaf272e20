"""C++ native oracle vs the NumPy spec oracle (bit-exact, all tiers agree)."""

import numpy as np
import pytest

from cute_nucleotides_jax.ops import native, oracle

ALPHABET = np.frombuffer(b"ACGTUNacgtun", dtype=np.uint8)


def test_native_available():
    assert native.available(), f"C++ oracle failed to build: see native.build_error"


@pytest.mark.parametrize("n", [0, 1, 4, 26, 27, 31, 32, 33, 100, 1000, 12345])
def test_n_to_bits_parity(rng, n):
    s = rng.choice(ALPHABET, size=n)
    assert np.array_equal(native.n_to_bits(s), oracle.n_to_bits_lut(s))


@pytest.mark.parametrize("n", [0, 1, 4, 26, 27, 31, 32, 33, 100, 1000, 12345])
def test_n_to_bits2_parity(rng, n):
    s = rng.choice(ALPHABET, size=n)
    assert np.array_equal(native.n_to_bits2(s), oracle.n_to_bits2_lut(s))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000])
def test_bits_to_n_parity(rng, n):
    s = rng.choice(ALPHABET, size=n)
    bits = oracle.n_to_bits_lut(s)
    assert np.array_equal(native.bits_to_n(bits, n), oracle.bits_to_n_lut(bits, n))


@pytest.mark.parametrize("n", [1, 26, 27, 28, 1000])
def test_bits_to_n2_parity(rng, n):
    s = rng.choice(ALPHABET, size=n)
    bits = oracle.n_to_bits2_lut(s)
    assert np.array_equal(native.bits_to_n2(bits, n), oracle.bits_to_n2_lut(bits, n))


def test_capacity_check():
    with pytest.raises(ValueError):
        native.bits_to_n(np.zeros(1, np.uint64), 33)
    with pytest.raises(ValueError):
        native.bits_to_n2(np.zeros(1, np.uint64), 28)


def test_arbitrary_bytes_defined(rng):
    # the framework defines out-of-alphabet behavior; all tiers must agree
    s = rng.integers(0, 256, size=999, dtype=np.int64).astype(np.uint8)
    assert np.array_equal(native.n_to_bits(s), oracle.n_to_bits_lut(s))
    assert np.array_equal(native.n_to_bits2(s), oracle.n_to_bits2_lut(s))


def test_find_invalid():
    assert native.find_invalid(b"ACGTUacgtuNn") == -1
    assert native.find_invalid(b"ACGTN", allow_n=False) == 4
    assert native.find_invalid(b"ACGTX") == 4
    assert native.find_invalid(b"") == -1


def test_memcpy():
    s = b"ACGT" * 100
    assert bytes(native.memcpy(s)) == s


def test_asan_selftest():
    """The native oracle passes its self-test under ASan+UBSan (SURVEY §5:
    host code provably clean, vs the reference's unsafe scalar tier)."""
    import os
    import shutil
    import subprocess

    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no native toolchain")
    d = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "cute_nucleotides_jax",
        "native",
    )
    r = subprocess.run(
        ["make", "-C", d, "asan-check"], capture_output=True, text=True, timeout=240
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NATIVE SELFTEST PASS" in r.stdout


def test_native_myers_vs_oracle(rng):
    from cute_nucleotides_jax.ops import align

    for _ in range(20):
        m = int(rng.integers(1, 90))
        n = int(rng.integers(0, 150))
        q = bytes(rng.choice(list(b"ACGTN"), size=m).astype(np.uint8))
        t = bytes(rng.choice(list(b"ACGTu"), size=n).astype(np.uint8))
        assert native.edit_distance(q, t) == align.edit_distance_reference(q, t)
        assert native.best_match(q, t) == align.best_match_reference(q, t)
    # degenerate shapes
    assert native.edit_distance(b"", b"ACGT") == 4
    assert native.best_match(b"", b"ACGT") == (0, 0)
    assert native.edit_distance(b"ACG", b"") == 3


def test_native_prefix_match(rng):
    from cute_nucleotides_jax.ops import align, oracle, spec

    for _ in range(10):
        m = int(rng.integers(1, 70))
        n = int(rng.integers(0, 120))
        q = bytes(rng.choice(list(b"ACGT"), size=m).astype(np.uint8))
        t = bytes(rng.choice(list(b"ACGT"), size=n).astype(np.uint8))
        d, e = native.prefix_match(q, t)
        # the device SHW mode is the ground truth here
        def pack(s):
            w = np.zeros((1, 2 * max(1, -(-len(s) // 32))), np.uint32)
            if s:
                v = spec.u64_to_u32_pairs(oracle.n_to_bits_lut(s)).reshape(-1)
                w[0, : v.size] = v
            return w
        dd, de = align.prefix_distance_packed(
            pack(q), np.array([m], np.int32), pack(t), np.array([n], np.int32)
        )
        assert (d, e) == (int(dd[0]), int(de[0])), (q, t)
    assert native.prefix_match(b"", b"ACG") == (0, 0)
