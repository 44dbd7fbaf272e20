"""End-to-end tour of the framework. Runs on CPU or GPU:

    python examples/quickstart.py
"""

import numpy as np
import jax
import jax.numpy as jnp

# --- 1. the reference-compatible host API ----------------------------------
from cute_nucleotides_jax import api, compat

words = api.n_to_bits(b"ATCGatcgUUUU")          # u64 packed, reference layout
print("packed:", [hex(w) for w in words])
print("decoded:", bytes(api.bits_to_n(words, 12)))

# the reference's exact function names also work:
assert compat.n_to_bits_movemask(b"ATCG" * 8)[0] == 0xD8D8D8D8D8D8D8D8

# --- 2. base-5 codec ({A,C,G,T/U,N}) ---------------------------------------
w5 = api.n_to_bits2(b"ATCGNatcgn")
print("base-5:", bytes(api.bits_to_n2(w5, 10)))

# --- 3. resident device batches (the production path) ----------------------
from cute_nucleotides_jax.models import TwoBitCodec

codec = TwoBitCodec()                            # the backend's XLA kernels
batch, lengths = codec.pad([b"ACGTACGTACGTACGT" * 8] * 64)
packed = codec.encode(jnp.asarray(batch))        # u32[B, W] on device
print("batch packed:", packed.shape, packed.dtype)

# --- 4. data-parallel over a device mesh -----------------------------------
from cute_nucleotides_jax import parallel

dp_words = parallel.data_parallel_encode(jnp.asarray(batch), gather=True)
print("mesh-encoded:", dp_words.shape, "on", len(jax.devices()), "device(s)")

# --- 5. streaming pipeline with resume -------------------------------------
from cute_nucleotides_jax.parallel.runtime import StreamingEncoder
from cute_nucleotides_jax.utils.io import Record

records = [Record(b"r%d" % i, b"ACGT" * 100) for i in range(32)]
enc = StreamingEncoder(batch_size=8, max_len=512)
stats = enc.run(records, sink=lambda words, b: None)
print("streamed:", stats["total_reads"], "reads,", stats["total_nt"], "nt")

# --- 6. packed-domain analytics (no decode needed) --------------------------
from cute_nucleotides_jax.ops import distance, seqops, spec

flat = np.ascontiguousarray(np.asarray(packed[0]))
print("GC content:", int(seqops.gc_content_packed(jnp.asarray(flat))))
rc = seqops.revcomp_packed(jnp.asarray(flat), int(lengths[0]))
print("revcomp words:", np.asarray(rc)[:2])
rc5 = seqops.revcomp_packed_b5(jnp.asarray(spec.u64_to_u32_pairs(w5).reshape(-1)), 10)
print("base-5 revcomp:", bytes(api.bits_to_n2(spec.u32_pairs_to_u64(np.asarray(rc5)), 10)))
reads = jnp.asarray(batch[:8, :64])
print("pairwise Hamming:\n", np.asarray(distance.pairwise_hamming(reads)))

# --- 7. k-mers at production k (no decode, no hash table) --------------------
from cute_nucleotides_jax.ops import kmer

lo, hi, counts = kmer.kmer_counts(jnp.asarray(flat), int(lengths[0]), k=21,
                                  canonical=True)
n_distinct = int((np.asarray(counts) > 0).sum())
print("distinct canonical 21-mers:", n_distinct,
      "total:", int(np.asarray(counts).sum()))

# --- 8. validated pipelines (corruption can't slip through) -----------------
# encode side: a byte outside the alphabet flags on the encode's own HBM
# read; decode side (base-5): a corrupt word (triplet >= 125 / pad bit)
# flags on the decode's read.  Both raise before anything is delivered.
from cute_nucleotides_jax.models import Base5Codec

b5 = Base5Codec()
reads5, lens5 = b5.pad([b"ACGTN" * 27] * 8)
words5, bad = b5.encode_checked(jnp.asarray(reads5))
print("encode valid:", not bool(np.any(np.asarray(bad))))
decoded, corrupt = b5.decode_checked(words5)
print("stream intact:", not bool(corrupt))

# --- 9. approximate matching (Myers bit-parallel, no decode) ----------------
# best occurrence of a query in every read of the resident batch, then a
# tiny host traceback turns the best hit into aligner output
from cute_nucleotides_jax.ops import align

query = b"ACGTACGAACGT"  # one substitution vs the reads' ACGT repeat
peq, m = align.peq_from_bytes(query)
B = packed.shape[0]
dists, ends = align.best_match_peq(
    jnp.broadcast_to(jnp.asarray(peq)[None], (B,) + peq.shape),
    jnp.full((B,), m, jnp.int32),
    packed,
    jnp.asarray(lengths, jnp.int32),
)
i = int(np.asarray(dists).argmin())
read_i = bytes(batch[i][: int(lengths[i])])
window = read_i[max(0, int(ends[i]) - (2 * m - 1)) : int(ends[i])]
d, s, e, cigar = align.semiglobal_traceback(query, window)
print(f"best occurrence: read {i}, dist {int(dists[i])}, cigar {cigar}")
