"""Operation tiers: spec constants, scalar oracles, XLA kernels, extras."""

from . import spec, oracle  # noqa: F401
# jax-dependent tiers are regular submodules; import lazily where startup
# cost matters: from cute_nucleotides_jax.ops import xla,
# native, validate, distance, kmer, seqops, search, sketch, align, sort
