"""cute-nucleotides-jax: a nucleotide codec engine for accelerators.

A from-scratch JAX/XLA framework with the capabilities of the Rust/AVX2
reference ``cute-nucleotides``: case-insensitive 2-bit packing of {A,C,G,T/U}
and base-5 triplet packing of {A,C,G,T/U,N}, bit-exact to the reference's
golden vectors, with scalar-oracle / native / XLA tiers and
data-parallel + long-sequence sharding over device meshes.
"""

from .ops import spec, oracle  # noqa: F401

__version__ = "0.1.0"

_LAZY = ("api", "compat", "models", "parallel", "utils", "cli")


def __getattr__(name):
    # jax-dependent layers load on first touch so `import cute_nucleotides_jax`
    # stays cheap for oracle-only consumers
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
