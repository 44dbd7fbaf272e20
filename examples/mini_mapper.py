"""A mini read mapper from framework ops — seed, extract, verify, report.

The minimap2 recipe, composed entirely from this framework's packed-domain
layers, with the reference and reads never decoded:

1. **Index**: (w, k)-minimizers of the reference (`ops.kmer.minimizers`,
   two log-depth windowed passes) -> a hash -> positions table.
2. **Seed**: each read's minimizers vote for a diagonal offset
   (reference_pos - read_pos); the top diagonal is the candidate locus.
3. **Extract**: a word-aligned candidate window is a plain slice of the
   packed reference words (0.25 bytes/nt).
4. **Verify**: ONE batched Myers semiglobal alignment
   (`ops.align.best_match_packed`) scores every read against its window
   and pins the exact end position + edit distance.

Run on any backend:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=. python examples/mini_mapper.py
"""

import numpy as np
import jax.numpy as jnp

from cute_nucleotides_jax.ops import align, kmer, oracle, spec

rng = np.random.default_rng(42)
REF_L, N_READS, READ_L = 100_000, 128, 100
K, W, PAD = 15, 10, 12

# --- reference: encode once, index its minimizers ---------------------------
ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=REF_L)
ref_w32 = spec.u64_to_u32_pairs(oracle.n_to_bits_lut(ref)).reshape(-1)
mask, hashes = (
    np.asarray(x) for x in kmer.minimizers(jnp.asarray(ref_w32), REF_L, K, W)
)
index: dict[int, list[int]] = {}
for p in np.nonzero(mask)[0]:
    index.setdefault(int(hashes[p]), []).append(int(p))
print(f"indexed {REF_L} nt: {mask.sum()} minimizers "
      f"(density {mask.sum() / (REF_L - K + 1):.3f}, expect ~{2 / (W + 1):.3f})")

# --- reads: sampled from the reference with ~2% substitutions ---------------
truth, reads = [], []
for _ in range(N_READS):
    p = int(rng.integers(0, REF_L - READ_L))
    r = bytearray(ref[p : p + READ_L].tobytes())
    for q in rng.choice(READ_L, size=rng.binomial(READ_L, 0.02), replace=False):
        r[q] = rng.choice([x for x in b"ACGT" if x != r[q]])
    truth.append(p)
    reads.append(bytes(r))

# --- seed: minimizer diagonal voting ----------------------------------------
cands = []
for r in reads:
    rw = spec.u64_to_u32_pairs(
        oracle.n_to_bits_lut(np.frombuffer(r, np.uint8))
    ).reshape(-1)
    m2, h2 = (
        np.asarray(x) for x in kmer.minimizers(jnp.asarray(rw), len(r), K, W)
    )
    votes: dict[int, int] = {}
    for q in np.nonzero(m2)[0]:
        for p in index.get(int(h2[q]), []):
            d = p - int(q)
            votes[d] = votes.get(d, 0) + 1
    cands.append(max(votes, key=votes.get) if votes else -1)
seeded = sum(c >= 0 for c in cands)
print(f"seeded {seeded}/{N_READS} reads via diagonal voting")

# --- extract + verify: one batched semiglobal alignment ---------------------
WIN = READ_L + 2 * PAD + 16
win_w = -(-WIN // 16)
qwords = np.zeros((N_READS, -(-READ_L // 32) * 2), np.uint32)
twords = np.zeros((N_READS, win_w), np.uint32)
bases = np.zeros(N_READS, np.int64)
for i, (r, c) in enumerate(zip(reads, cands)):
    v = spec.u64_to_u32_pairs(
        oracle.n_to_bits_lut(np.frombuffer(r, np.uint8))
    ).reshape(-1)
    qwords[i, : v.size] = v
    ws = max(0, (c - PAD) if c >= 0 else 0) // 16  # word-aligned window
    bases[i] = 16 * ws
    tw = ref_w32[ws : ws + win_w]
    twords[i, : tw.size] = tw
tl = np.minimum(WIN, REF_L - bases).astype(np.int32)
dists, ends = (
    np.asarray(x)
    for x in align.best_match_packed(
        qwords, np.full(N_READS, READ_L, np.int32), twords, tl
    )
)

# --- report ------------------------------------------------------------------
mapped_end = bases + ends  # reference coordinate of each match end
ok = 0
for i in range(N_READS):
    if cands[i] >= 0 and abs(int(mapped_end[i]) - (truth[i] + READ_L)) <= PAD:
        ok += 1
print(f"mapped within +-{PAD} nt of truth: {ok}/{N_READS}; "
      f"edit distances: median {int(np.median(dists))}, max {int(dists.max())}")
assert ok >= int(0.95 * N_READS), "mapper should place >=95% of reads"
assert np.median(dists) <= 4, "2% error reads should align with few edits"
print("ok")
