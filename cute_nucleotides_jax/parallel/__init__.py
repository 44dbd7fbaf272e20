"""Parallelism layer: device meshes, data-parallel batch codecs, block-sharded
long-sequence mode, and the multi-host runtime.

The reference has no parallelism of any kind (single-threaded loops,
reference src/n_to_bits.rs:93,135,180,236,279,323,370); its only data
parallelism is SIMD lanes inside one AVX2 register.  On a device mesh the
analogous axes are first-class (SURVEY.md §2.3):

* **Data parallel (DP)** — batches of reads sharded over the mesh
  (:func:`data_parallel_encode` / :class:`ShardedCodec`).
* **Sequence/block parallel** — one very long sequence split across devices at
  word-aligned boundaries so packed words concatenate bit-exactly
  (:mod:`cute_nucleotides_jax.parallel.longseq`).
* **Multi-host** — `jax.distributed` runtime + host-sharded streams
  (:mod:`cute_nucleotides_jax.parallel.runtime`).
"""

from .mesh import make_mesh, default_mesh  # noqa: F401
from .data_parallel import ShardedCodec, data_parallel_encode, data_parallel_decode, kmer_spectrum, match_counts, sketch_sharded, edit_distances  # noqa: F401
from .longseq import encode_long_2bit, encode_long_b5, decode_long_2bit, decode_long_b5  # noqa: F401
