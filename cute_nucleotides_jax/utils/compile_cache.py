"""Persistent compilation cache location (one helper for every entry point)."""

from __future__ import annotations

import os


def enable() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it stands (JAX
    reads it itself and no other directory is set here).  Otherwise the
    cache lives at the fixed ``<checkout>/.jax_cache`` (listed in
    ``.gitignore``): the path is part of the cache key, so it must not
    move between runs.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    checkout = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    path = os.path.join(checkout, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
