"""Hamming distance ops (the reference's equidistant-code idea, implemented)."""

import numpy as np

import jax.numpy as jnp

from cute_nucleotides_jax.ops import distance, oracle, spec, xla
import jax


def _np_hamming(a: np.ndarray, b: np.ndarray) -> int:
    fa = (a >> 1) & 3
    fb = (b >> 1) & 3
    return int(np.sum(fa != fb))


def test_hamming_seqs(rng):
    a = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=500)
    b = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=500)
    got = int(distance.hamming_seqs(jnp.asarray(a), jnp.asarray(b)))
    assert got == _np_hamming(a, b)
    # T/U and case insensitivity
    x = np.frombuffer(b"ACGT", np.uint8)
    y = np.frombuffer(b"acgu", np.uint8)
    assert int(distance.hamming_seqs(jnp.asarray(x), jnp.asarray(y))) == 0


def test_hamming_packed_matches_bytes(rng):
    n = 32 * 40
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    b = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    wa = jax.jit(xla.encode_2bit_words)(jnp.asarray(a)).reshape(-1)
    wb = jax.jit(xla.encode_2bit_words)(jnp.asarray(b)).reshape(-1)
    got = int(distance.hamming_packed(wa, wb))
    assert got == _np_hamming(a, b)


def test_pairwise_hamming(rng):
    B, L = 6, 96
    batch = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=(B, L))
    got = np.asarray(distance.pairwise_hamming(jnp.asarray(batch)))
    for i in range(B):
        for j in range(B):
            assert got[i, j] == _np_hamming(batch[i], batch[j]), (i, j)
    assert (np.diag(got) == 0).all()


def test_pairwise_hamming_chunked_and_packed(rng):
    """Chunked int8 path == naive; packed variant agrees on padded batch."""
    from cute_nucleotides_jax.ops import oracle, spec

    B, L = 12, 100  # L not a chunk multiple
    reads = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=(B, L))
    d = np.asarray(distance.pairwise_hamming(jnp.asarray(reads), chunk=64))
    folded = (reads >> 1) & 3
    want = (folded[:, None, :] != folded[None, :, :]).sum(-1)
    assert np.array_equal(d, want)

    # packed: pad to 32-nt blocks with 'A' (identical padding cancels)
    pad = (-L) % 32
    padded = np.concatenate(
        [reads, np.full((B, pad), ord("A"), np.uint8)], axis=1
    )
    words = np.stack(
        [
            spec.u64_to_u32_pairs(oracle.n_to_bits_lut(r)).reshape(-1)
            for r in padded
        ]
    )
    dp = np.asarray(
        distance.pairwise_hamming_packed(jnp.asarray(words), chunk=64)
    )
    assert np.array_equal(dp, want)
