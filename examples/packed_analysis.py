"""Packed-domain analysis: everything you can do WITHOUT decoding.

The point of a 2-bit codec in production is that downstream analyses run on
the packed stream at 1/4 the memory traffic.  This example encodes a batch
of reads once, then computes — all on device, all from packed words:

* GC content (masked popcount)
* reverse complements (SWAR field reversal)
* a k-mer spectrum (planar funnel-shift extraction + scatter-add
  histogram)
* all-pairs Hamming distances (length-chunked int8 one-hot matmuls)
* approximate search (Myers bit-parallel edit distance, word-native scan)

Run on any backend:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=. python examples/packed_analysis.py
"""

import numpy as np
import jax
import jax.numpy as jnp

from cute_nucleotides_jax.models import TwoBitCodec
from cute_nucleotides_jax.ops import distance, kmer, seqops, spec

rng = np.random.default_rng(0)
B, L = 64, 512
reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))

# --- encode once -----------------------------------------------------------
codec = TwoBitCodec()
words = codec.encode(jnp.asarray(reads))        # u32[B, L//16], device
print(f"encoded {B} reads x {L} nt -> {words.shape} u32 words "
      f"({words.size * 4 / (B * L):.2f} bytes/nt)")

# --- GC content (no decode) ------------------------------------------------
gc = np.asarray(seqops.gc_content_packed(words)) / L
print(f"GC content: mean {gc.mean():.3f}  min {gc.min():.3f}  max {gc.max():.3f}")

# --- reverse complements (no decode) ---------------------------------------
rc0 = seqops.revcomp_packed(jnp.asarray(words[0]).reshape(-1), L)
back = codec.decode(rc0.reshape(1, -1))
rc_ascii = np.asarray(back).reshape(-1)[:L].tobytes()
fwd_ascii = reads[0].tobytes()
comp = bytes.maketrans(b"ACGT", b"TGCA")
assert rc_ascii == fwd_ascii.translate(comp)[::-1]
print(f"revcomp(read 0): {rc_ascii[:32].decode()}...")

# --- region extraction (no decode) ------------------------------------------
# samtools-faidx style: cut a window straight from the packed words, then
# splice it back — both on device, one funnel pass each
win = seqops.packed_slice(jnp.asarray(words[0]).reshape(-1), 37, 61)
assert np.asarray(
    codec.decode(win.reshape(1, -1))
).reshape(-1)[:61].tobytes() == reads[0, 37:98].tobytes()
rejoined = seqops.packed_concat(
    seqops.packed_slice(jnp.asarray(words[0]).reshape(-1), 0, 37), 37,
    seqops.packed_slice(jnp.asarray(words[0]).reshape(-1), 37, L - 37), L - 37,
)
assert np.array_equal(np.asarray(rejoined), np.asarray(words[0]).reshape(-1))
print(f"packed_slice(37, 61) + packed_concat splice back: ok")

# --- k-mer spectrum (planar extraction + scatter-add histogram) -----------
# reads are independent sequences: kmer_histogram_batch zeroes the per-row
# successor stream so windows never span a read boundary (flattening the
# batch would count (B-1)*(k-1) phantom junction k-mers), and masks ragged
# tails via lengths — one device pass for the whole batch
k = 8
hist = np.asarray(
    kmer.kmer_histogram_batch(jnp.asarray(words), L, k)
).astype(np.int64)
top = np.argsort(hist)[::-1][:5]


def kmer_str(code: int) -> str:
    return "".join("ACTG"[(code >> (2 * i)) & 3] for i in range(k))


print(f"top {k}-mers:",
      ", ".join(f"{kmer_str(int(c))}x{int(hist[c])}" for c in top))
print(f"distinct {k}-mers: {(hist > 0).sum()} / {4 ** k}")

# --- all-pairs distances (int8 one-hot products) -------------------------
d = np.asarray(distance.pairwise_hamming(jnp.asarray(reads)))
iu = np.triu_indices(B, 1)
print(f"pairwise Hamming: mean {d[iu].mean():.1f} of {L} "
      f"(expect ~{0.75 * L:.0f} for random)")
assert (np.diag(d) == 0).all() and (d == d.T).all()

# --- approximate search (Myers bit-parallel, no decode) --------------------
from cute_nucleotides_jax.ops import align

query = bytes(reads[7, 100:130])  # a 30-nt substring of read 7
peq, qm = align.peq_from_bytes(query)
dists, ends = align.best_match_peq(
    jnp.broadcast_to(jnp.asarray(peq)[None], (B,) + peq.shape),
    jnp.full((B,), qm, jnp.int32),
    words,
    jnp.full((B,), L, jnp.int32),
)
dists, ends = np.asarray(dists), np.asarray(ends)
print(f"best occurrence of a read-7 30-mer: dist {dists.min()} "
      f"(read {dists.argmin()}, end {ends[dists.argmin()]}); "
      f"median dist elsewhere {int(np.median(dists))}")
assert dists[7] == 0 and ends[7] == 130

# --- and the stream is still bit-exact to the reference layout -------------
w0 = spec.u32_pairs_to_u64(np.asarray(words[0]))
print(f"read 0, word 0 (reference u64 layout): 0x{w0[0]:016x}")
print("ok")
