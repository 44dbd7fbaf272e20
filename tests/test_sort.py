"""Two-key u32 pair sort vs np.lexsort (the host oracle)."""

import numpy as np
import pytest

import jax.numpy as jnp

from cute_nucleotides_jax.ops import sort


def _oracle(hi, lo):
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


COLS = 1024


def _check(hi, lo):
    wh, wl = _oracle(hi, lo)
    hs, ls = sort.sort_pairs(jnp.asarray(hi), jnp.asarray(lo))
    assert np.array_equal(np.asarray(hs), wh)
    assert np.array_equal(np.asarray(ls), wl)


@pytest.mark.parametrize(
    "n",
    [
        1,
        17,
        4096 - 1,
        4 * COLS,
        8 * COLS,
        8 * COLS + 37,   # not a power of two
        16 * COLS - 1,
    ],
)
def test_sort_pairs_matches_lexsort(rng, n):
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    _check(hi, lo)


def test_sort_pairs_kmer_shaped_keys(rng):
    """The kmer_counts key distribution: small hi (2k-32 bits), many
    sentinel pairs at 0xFFFFFFFF, heavy lo duplication."""
    n = 8 * COLS
    hi = rng.integers(0, 1 << 10, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 5000, n, dtype=np.uint64).astype(np.uint32)
    hi[-1500:] = 0xFFFFFFFF
    lo[-1500:] = 0xFFFFFFFF
    _check(hi, lo)


def test_sort_pairs_adversarial_orders(rng):
    n = 4 * COLS
    asc = np.arange(n, dtype=np.uint32)
    _check(asc[::-1].copy(), asc.copy())          # descending hi
    _check(np.zeros(n, np.uint32), asc[::-1].copy())  # ties on hi
    _check(np.full(n, 7, np.uint32), np.full(n, 3, np.uint32))  # all equal
    # unsigned-order trap: values straddling the i32 sign bit
    hi = rng.integers(2**31 - 4, 2**31 + 4, n, dtype=np.uint64).astype(
        np.uint32
    )
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    _check(hi, lo)


def test_sort_pairs_rejects_bad_dtypes():
    with pytest.raises(TypeError):
        sort.sort_pairs(
            jnp.zeros(8, jnp.int32), jnp.zeros(8, jnp.uint32)
        )
    with pytest.raises(TypeError):
        sort.sort_pairs(jnp.zeros(8, jnp.uint32), jnp.zeros(9, jnp.uint32))
    # 2-D keys sort as their flattened streams
    hs, ls = sort.sort_pairs(
        jnp.asarray([[3, 1], [2, 1]], jnp.uint32), jnp.asarray([[0, 9], [5, 2]], jnp.uint32)
    )
    assert np.asarray(hs).tolist() == [1, 1, 2, 3]
    assert np.asarray(ls).tolist() == [2, 9, 5, 0]
