"""Lexicographic sort of u32 key pairs — the sort behind
:func:`.kmer.kmer_counts`.

The reference has no sort (its API stops at the codec); k-mer counting
needs one (reference README.md:139-151 motivates k-mer workloads as the
codec's downstream consumer).  ``jax.lax.sort`` with two keys is the
device sort here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["sort_pairs"]


def sort_pairs(hi: jax.Array, lo: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Sort u32 pairs by ``(hi, lo)`` ascending (unsigned, lexicographic):
    -> (hi_sorted, lo_sorted), both u32[n] (inputs are flattened)."""
    if hi.shape != lo.shape:
        raise TypeError(f"key shapes differ: {hi.shape} vs {lo.shape}")
    if hi.dtype != jnp.uint32 or lo.dtype != jnp.uint32:
        raise TypeError(f"expected u32 keys, got {hi.dtype}/{lo.dtype}")
    hs, ls = jax.lax.sort((hi.reshape(-1), lo.reshape(-1)), num_keys=2)
    return hs, ls
