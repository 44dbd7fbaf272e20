"""End-to-end smoke test of the codec engine on one NVIDIA GPU.

    python chip_smoke.py [--seed N]          # one card: all single-card phases
    python chip_smoke.py --multi [--seed N]  # four cards: the mesh phase only

Phases (each a plain function that raises on any mismatch; nothing is caught):

* ingest     — 1,000,000 Illumina-shaped FASTQ reads (150 nt trimmed raggedly
               to 100-150) through ``cli encode --batch --validate`` and
               ``cli decode --batch`` in both codecs; decoded FASTA == input
               (case-folded, U->T) and every record's .nup words == the native
               C++ oracle.  Prints reads/s and Gbp/s.
* chromosome — one GRCh38-chr1-length sequence (248,956,422 nt, 10 kb N gaps
               every 20 Mb plus both telomeres) through ``Base5Codec`` and,
               with N mapped to A, ``TwoBitCodec`` resident batches; bit-exact
               against the native oracle.
* kernels    — every codec kernel variant at the resident-batch width
               (32768 x 8192 nt 2-bit, 32768 x 8208 nt base-5) compared
               bit-exactly with each other and with the native oracle (all
               integer ops: tolerance zero), with device times.
* reach      — every op that once routed to a hand-written kernel, run once
               above its old routing threshold against a NumPy or native
               oracle.
* multi      — (``--multi``, four cards) the data-parallel, checked,
               long-sequence, spectrum, sketch and grep paths on a 4-device
               mesh against the single-device result and the oracle.

Data is generated from ``--seed``.  The script refuses to run without a GPU.
Its last stdout line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

from cute_nucleotides_jax import cli, compat, models
from cute_nucleotides_jax.ops import (
    align,
    distance,
    kmer,
    native,
    search,
    seqops,
    sketch,
    sort,
    spec,
    xla,
)
from cute_nucleotides_jax.utils import compile_cache, profiling

CARD = ""  # nvidia-smi "name, power.limit", set in main()


def log(*a) -> None:
    print(*a, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rate_line(what: str, n_items: float, unit: str, seconds: float) -> None:
    log(f"  {what}: {n_items / seconds:,.4f} {unit}/s ({seconds:.3f} s) [{CARD}]")


# --- NumPy oracles ------------------------------------------------------------

CODE2 = (np.arange(256) >> 1) & 3  # the 2-bit code of every byte


def np_codes(codes2: np.ndarray, k: int) -> np.ndarray:
    """Position-ordered k-mer codes (LSB-first, u64) of a 2-bit code stream."""
    n = codes2.size - k + 1
    out = np.zeros(n, np.uint64)
    for j in range(k):
        out |= codes2[j : j + n].astype(np.uint64) << np.uint64(2 * j)
    return out


def np_revcomp(codes: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros_like(codes)
    for j in range(k):
        d = (codes >> np.uint64(2 * j)) & np.uint64(3)
        out |= (d ^ np.uint64(2)) << np.uint64(2 * (k - 1 - j))
    return out


def np_mix32(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def np_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    if k <= 15:
        return np_mix32(codes.astype(np.uint32))
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    return np_mix32(lo ^ np_mix32(hi))


def np_matches(seq: np.ndarray, query: bytes, wildcard: int) -> np.ndarray:
    """Start positions where ``query`` matches the normalized ``seq``."""
    from numpy.lib.stride_tricks import sliding_window_view

    q = np.frombuffer(query, np.uint8)
    win = sliding_window_view(seq, q.size)
    care = q != wildcard
    return np.flatnonzero(np.all((win == q) | ~care, axis=1))


def normalize(seq: np.ndarray) -> np.ndarray:
    up = seq & np.uint8(0xDF)
    return np.where(up == ord("U"), np.uint8(ord("T")), up)


def packed_2bit(seq: np.ndarray) -> jax.Array:
    return jnp.asarray(spec.u64_to_u32_pairs(native.n_to_bits(seq)).reshape(-1))


def packed_b5(seq: np.ndarray) -> jax.Array:
    return jnp.asarray(spec.u64_to_u32_pairs(native.n_to_bits2(seq)).reshape(-1))


def unpack_bits(bits: np.ndarray, per_lane: int) -> np.ndarray:
    flat = bits.reshape(-1).astype(np.uint64)
    m = (flat[:, None] >> np.arange(per_lane, dtype=np.uint64)) & np.uint64(1)
    return np.flatnonzero(m.reshape(-1))


# --- phases -----------------------------------------------------------------


def make_reads(rng, n_reads: int, n_rate: float):
    """Illumina-shaped reads: 150 nt trimmed to 100..150, ~1% lowercase
    (soft-masked) and a sprinkle of U, N at ``n_rate``."""
    lengths = rng.integers(100, 151, n_reads)
    total = int(lengths.sum())
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, total)]
    if n_rate:
        bases[rng.random(total) < n_rate] = ord("N")
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    soft = rng.random(n_reads) < 0.01
    for i in np.flatnonzero(soft):
        bases[starts[i] : starts[i] + lengths[i]] |= np.uint8(0x20)
    u_pos = rng.integers(0, total, 1000)
    bases[u_pos] = np.where(bases[u_pos] == ord("T"), ord("U"), bases[u_pos])
    quals = rng.integers(33, 75, total).astype(np.uint8)
    return bases, quals, starts, lengths


def write_fastq(path: str, bases, quals, starts, lengths) -> None:
    bb, qb = bases.tobytes(), quals.tobytes()
    parts = []
    for i, (s, n) in enumerate(zip(starts.tolist(), lengths.tolist())):
        parts.append(b"@r%d\n%s\n+\n%s\n" % (i, bb[s : s + n], qb[s : s + n]))
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def read_fasta_seqs(path: str) -> list[bytes]:
    seqs, cur = [], []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if cur or seqs:
                    seqs.append(b"".join(cur))
                cur = []
            else:
                cur.append(line.rstrip(b"\n"))
    seqs.append(b"".join(cur))
    return seqs


def phase_ingest(seed: int, n_reads: int = 1_000_000, batch: int = 65536) -> None:
    log("phase ingest")
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as d:
        for codec, n_rate in (("2bit", 0.0), ("base5", 0.001)):
            bases, quals, starts, lengths = make_reads(rng, n_reads, n_rate)
            fq, nup, fa = (os.path.join(d, f"reads.{x}") for x in ("fq", "nup", "fa"))
            write_fastq(fq, bases, quals, starts, lengths)
            nt = int(lengths.sum())
            t0 = time.perf_counter()
            rc = cli.main(["encode", fq, nup, "--codec", codec, "--batch", str(batch),
                           "--validate", "--max-len", "150"])
            t_enc = time.perf_counter() - t0
            check(rc == 0, f"{codec} cli encode rc={rc}")
            dec_args = ["decode", nup, fa, "--batch", str(batch)]
            if codec == "base5":
                dec_args.append("--verify-stream")
            t0 = time.perf_counter()
            rc = cli.main(dec_args)
            t_dec = time.perf_counter() - t0
            check(rc == 0, f"{codec} cli decode rc={rc}")
            got = read_fasta_seqs(fa)
            check(len(got) == n_reads, f"{codec}: {len(got)} decoded records")
            want_all = normalize(bases).tobytes()
            oracle_fn = native.n_to_bits if codec == "2bit" else native.n_to_bits2
            with cli.NupReader(nup) as r:
                check(len(r) == n_reads, f"{codec}: {len(r)} .nup records")
                for i, (name, length, words) in enumerate(r):
                    s, n = int(starts[i]), int(lengths[i])
                    check(length == n, f"{codec} record {i} length {length} != {n}")
                    check(got[i] == want_all[s : s + n], f"{codec} record {i} decode")
                    check(np.array_equal(words, oracle_fn(bases[s : s + n])),
                          f"{codec} record {i} words != native oracle")
            log(f"  {codec}: {n_reads} reads, {nt} nt, decoded FASTA == input and "
                f".nup words == native oracle")
            rate_line(f"{codec} cli encode --batch --validate", n_reads, "reads", t_enc)
            rate_line(f"{codec} cli encode --batch --validate", nt / 1e9, "Gbp", t_enc)
            rate_line(f"{codec} cli decode --batch", n_reads, "reads", t_dec)
            rate_line(f"{codec} cli decode --batch", nt / 1e9, "Gbp", t_dec)


CHR1_LEN = 248_956_422


def make_chromosome(rng) -> np.ndarray:
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, CHR1_LEN, dtype=np.uint8)]
    gap = 10_000
    seq[:gap] = ord("N")
    seq[-gap:] = ord("N")
    for p in range(20_000_000, CHR1_LEN - gap, 20_000_000):
        seq[p : p + gap] = ord("N")
    return seq


def rows_of(seq: np.ndarray, width: int) -> np.ndarray:
    rows = -(-seq.size // width)
    out = np.full(rows * width, ord("A"), np.uint8)
    out[: seq.size] = seq
    return out.reshape(rows, width)


def phase_chromosome(seed: int) -> None:
    log("phase chromosome")
    seq = make_chromosome(np.random.default_rng(seed + 1))
    n = seq.size
    # base-5: N gaps kept; rows of 8208 nt (304 words) concatenate to the stream
    codec5 = models.Base5Codec()
    x5 = jnp.asarray(rows_of(seq, 8208))
    t0 = time.perf_counter()
    w5 = codec5.encode(x5)
    w5_host = np.asarray(w5)
    t_enc = time.perf_counter() - t0
    words5 = spec.u32_pairs_to_u64(w5_host.reshape(-1))[: spec.num_words_b5(n)]
    want5 = native.n_to_bits2(seq)
    check(np.array_equal(words5, want5), "chromosome base-5 words != native oracle")
    t0 = time.perf_counter()
    back5 = np.asarray(codec5.decode(w5)).reshape(-1)[:n]
    t_dec = time.perf_counter() - t0
    check(np.array_equal(back5, native.bits_to_n2(want5, n)),
          "chromosome base-5 decode != native oracle")
    log(f"  base-5: {n} nt -> {w5_host.nbytes} packed bytes, bit-exact both ways")
    rate_line("base-5 encode incl. transfers", n / 1e9, "Gbp", t_enc)
    rate_line("base-5 decode incl. transfers", n / 1e9, "Gbp", t_dec)
    # 2-bit: N mapped to A
    seq2 = np.where(seq == ord("N"), np.uint8(ord("A")), seq)
    codec2 = models.TwoBitCodec()
    x2 = jnp.asarray(rows_of(seq2, 8192))
    w2 = codec2.encode(x2)
    words2 = spec.u32_pairs_to_u64(np.asarray(w2).reshape(-1))[: spec.num_words_2bit(n)]
    want2 = native.n_to_bits(seq2)
    check(np.array_equal(words2, want2), "chromosome 2-bit words != native oracle")
    back2 = np.asarray(codec2.decode(w2)).reshape(-1)[:n]
    check(np.array_equal(back2, native.bits_to_n(want2, n)),
          "chromosome 2-bit decode != native oracle")
    log(f"  2-bit: {n} nt, bit-exact both ways")


def phase_kernels(seed: int, rows: int = 32768) -> None:
    log("phase kernels")
    rng = np.random.default_rng(seed + 2)
    trace_dir = tempfile.mkdtemp(prefix="smoke_trace_")

    def timed(name, fn, *args, nbytes):
        s = profiling.measure_device_seconds(jax.jit(fn), *args, log_dir=trace_dir)
        if s is None:
            log(f"  {name:26s} device time not measured (no device events)")
            return
        log(f"  {name:26s} {s * 1e3:8.4f} ms device  {nbytes / s / 1e9:7.1f} GB/s [{CARD}]")

    h2 = np.frombuffer(b"ACGTacgtUu", np.uint8)[rng.integers(0, 10, (rows, 8192), dtype=np.uint8)]
    x2 = jnp.asarray(h2)
    nb2 = h2.size * 5 // 4
    want_words = spec.u64_to_u32_pairs(native.n_to_bits(h2.reshape(-1))).reshape(rows, -1)
    for v in xla.ENCODE_2BIT_VARIANTS:
        got = np.asarray(jax.jit(functools.partial(xla.encode_2bit_words, variant=v))(x2))
        check(np.array_equal(got, want_words), f"encode_2bit {v} != native oracle")
        timed(f"encode_2bit[{v}]", functools.partial(xla.encode_2bit_words, variant=v),
              x2, nbytes=nb2)
    words, bad = jax.jit(xla.encode_2bit_words_checked)(x2)
    check(np.array_equal(np.asarray(words), want_words) and not np.asarray(bad).any(),
          "encode_2bit_checked on clean input")
    timed("encode_2bit_checked", xla.encode_2bit_words_checked, x2, nbytes=nb2)
    poisoned = x2.at[rows - 1, 4000].set(ord("X"))
    bad = np.asarray(jax.jit(xla.encode_2bit_words_checked)(poisoned)[1])
    check(np.flatnonzero(bad).tolist() == [rows - 1], "encode_2bit_checked flags")
    w2 = jnp.asarray(want_words)
    want_dec = normalize(h2)
    for v in xla.DECODE_2BIT_VARIANTS:
        got = np.asarray(jax.jit(functools.partial(xla.decode_2bit_bytes, variant=v))(w2))
        check(np.array_equal(got, want_dec), f"decode_2bit {v} != oracle")
        timed(f"decode_2bit[{v}]", functools.partial(xla.decode_2bit_bytes, variant=v),
              w2, nbytes=nb2)
    del x2, w2, poisoned, h2
    h5 = np.frombuffer(b"ACGTNacgtnUu", np.uint8)[rng.integers(0, 12, (rows, 8208), dtype=np.uint8)]
    x5 = jnp.asarray(h5)
    nb5 = h5.size + h5.size // 27 * 8
    want5 = native.n_to_bits2(h5.reshape(-1))
    got5 = np.asarray(jax.jit(xla.encode_b5_words)(x5))
    check(np.array_equal(spec.u32_pairs_to_u64(got5.reshape(-1)), want5),
          "encode_b5 != native oracle")
    timed("encode_b5", xla.encode_b5_words, x5, nbytes=nb5)
    words5, bad5 = jax.jit(xla.encode_b5_words_checked)(x5)
    check(np.array_equal(np.asarray(words5), got5) and not bool(bad5), "encode_b5_checked")
    timed("encode_b5_checked", xla.encode_b5_words_checked, x5, nbytes=nb5)
    w5 = jnp.asarray(got5)
    dec5 = np.asarray(jax.jit(xla.decode_b5_bytes)(w5))
    check(np.array_equal(dec5.reshape(-1), native.bits_to_n2(want5, h5.size)),
          "decode_b5 != native oracle")
    timed("decode_b5", xla.decode_b5_bytes, w5, nbytes=nb5)
    dchk, dbad = models.Base5Codec().decode_checked(w5)
    check(np.array_equal(np.asarray(dchk), dec5) and not bool(dbad), "decode_b5_checked")
    corrupt = w5.at[7, 9].set(w5[7, 9] | jnp.uint32(1 << 31))
    check(bool(models.Base5Codec().decode_checked(corrupt)[1]), "decode_b5_checked flag")


def phase_reach(seed: int) -> None:
    log("phase reach")
    rng = np.random.default_rng(seed + 3)
    L = 4_000_000
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)]
    w = packed_2bit(seq)  # 250,000 u32 words, far above every old threshold
    codes2 = CODE2[seq]

    # match_bits (2-bit, N wildcard) with 7 nt and 45 nt queries
    for q in (b"GATNACA", bytes(seq[1_234_567 : 1_234_567 + 45])):
        got = unpack_bits(np.asarray(search.match_bits(w, L, q)), 16)
        want = np_matches(seq, q, ord("N"))
        check(np.array_equal(got, want), f"match_bits {len(q)} nt")
        check(int(search.match_count(w, L, q)) == want.size, "match_count")
    log("  match_bits 7/45 nt == numpy")

    # base-5 stream with N: match_bits_b5 ('?' wildcard, N literal)
    seq5 = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, L)]
    w5 = packed_b5(seq5)
    for q in (b"GAT?ACN", bytes(seq5[2_000_001 : 2_000_001 + 45])):
        got = unpack_bits(np.asarray(search.match_bits_b5(w5, L, q)), 27)
        want = np_matches(seq5, q, ord("?"))
        check(np.array_equal(got, want), f"match_bits_b5 {len(q)} nt")
    log("  match_bits_b5 7/45 nt == numpy")

    # kmer_histogram k=8
    h = np.asarray(kmer.kmer_histogram(w, L, 8))
    check(np.array_equal(h, np.bincount(np_codes(codes2, 8).astype(np.int64), minlength=4**8)),
          "kmer_histogram k=8")
    # kmer_histogram_batch: ragged reads
    B, RL = 256, 512
    rs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (B, RL))]
    rlen = rng.integers(0, RL + 1, B)
    rw = jnp.asarray(np.stack([spec.u64_to_u32_pairs(native.n_to_bits(r)).reshape(-1) for r in rs]))
    hb = np.asarray(kmer.kmer_histogram_batch(rw, jnp.asarray(rlen, jnp.int32), 8))
    want_b = np.zeros(4**8, np.int64)
    for r, n in zip(rs, rlen):
        if n >= 8:
            want_b += np.bincount(np_codes(CODE2[r[:n]], 8).astype(np.int64), minlength=4**8)
    check(np.array_equal(hb, want_b), "kmer_histogram_batch k=8")
    log("  kmer_histogram (k=8) and kmer_histogram_batch == numpy")

    # kmer_counts k=21 canonical
    c21 = np_codes(codes2, 21)
    canon = np.minimum(c21, np_revcomp(c21, 21))
    uniq, cnt = np.unique(canon, return_counts=True)
    lo, hi, counts = (np.asarray(a) for a in kmer.kmer_counts(w, L, 21, canonical=True))
    sel = counts > 0
    got_codes = (hi[sel].astype(np.uint64) << np.uint64(32)) | lo[sel].astype(np.uint64)
    check(np.array_equal(got_codes, uniq) and np.array_equal(counts[sel], cnt),
          "kmer_counts k=21")
    log(f"  kmer_counts k=21: {uniq.size} distinct == numpy")

    # minimizers / minimizer_bits k=15 w=10
    from numpy.lib.stride_tricks import sliding_window_view

    c15 = np_codes(codes2, 15)
    h15 = np_hashes(np.minimum(c15, np_revcomp(c15, 15)), 15)
    wm = sliding_window_view(h15, 10).min(axis=1)
    padded = np.concatenate([np.zeros(9, np.uint32), wm, np.zeros(9, np.uint32)])
    want_mask = h15 == sliding_window_view(padded, 10).max(axis=1)[: h15.size]
    mask, hh = kmer.minimizers(w, L, 15, 10)
    check(np.array_equal(np.asarray(hh), h15), "minimizer hashes")
    check(np.array_equal(np.asarray(mask), want_mask), "minimizers k=15 w=10")
    got_bits = unpack_bits(np.asarray(kmer.minimizer_bits(w, L, 15, 10)), 16)
    check(np.array_equal(got_bits, np.flatnonzero(want_mask)), "minimizer_bits")
    log("  minimizers / minimizer_bits k=15 w=10 == numpy")

    # bottom_k_sketch k=21 s=1000
    h21 = np.unique(np_hashes(canon, 21))
    h21 = h21[h21 != 0xFFFFFFFF][:1000]
    sk = np.asarray(sketch.bottom_k_sketch(w, L, 21, 1000))
    check(np.array_equal(sk, h21), "bottom_k_sketch k=21 s=1000")
    log("  bottom_k_sketch k=21 s=1000 == numpy")

    # gc_content_packed_b5 on the 4 Mnt base-5 stream
    gc = int(seqops.gc_content_packed_b5(w5))
    check(gc == int(np.isin(seq5, np.frombuffer(b"CG", np.uint8)).sum()), "gc_content_packed_b5")
    # sort_pairs
    a = rng.integers(0, 2**32, 1 << 22, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 1 << 22, dtype=np.uint64).astype(np.uint32)
    hs, ls = sort.sort_pairs(jnp.asarray(a), jnp.asarray(b))
    order = np.lexsort((b, a))
    check(np.array_equal(np.asarray(hs), a[order]) and np.array_equal(np.asarray(ls), b[order]),
          "sort_pairs")
    log("  gc_content_packed_b5 and sort_pairs (4 Mi pairs) == numpy")

    # the reference's 13 names (1 Mnt, mixed case + U; base-5 with N)
    s1 = np.frombuffer(b"ACGTacgtUu", np.uint8)[rng.integers(0, 10, 1_000_003)]
    s5 = np.frombuffer(b"ACGTNacgtnUu", np.uint8)[rng.integers(0, 12, 1_000_003)]
    w1, w15 = native.n_to_bits(s1), native.n_to_bits2(s5)
    for name in ("n_to_bits_lut", "n_to_bits_pext", "n_to_bits_shift",
                 "n_to_bits_movemask", "n_to_bits_mul"):
        check(np.array_equal(getattr(compat, name)(s1), w1), f"compat.{name}")
    for name in ("bits_to_n_lut", "bits_to_n_shuffle", "bits_to_n_pdep", "bits_to_n_clmul"):
        check(np.array_equal(getattr(compat, name)(w1, s1.size), normalize(s1)), f"compat.{name}")
    check(np.array_equal(compat.n_to_bits2_lut(s5), w15), "compat.n_to_bits2_lut")
    check(np.array_equal(compat.n_to_bits2_pext(s5), w15), "compat.n_to_bits2_pext")
    for name in ("bits_to_n2_lut", "bits_to_n2_pdep"):
        check(np.array_equal(getattr(compat, name)(w15, s5.size), normalize(s5)), f"compat.{name}")
    log("  all 13 compat names == native oracle (1 Mnt)")

    # pairwise_hamming: the int8 one-hot dot_general, exact
    rd = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (64, 4096))]
    c = CODE2[rd]
    want_h = np.stack([(c[i][None, :] != c).sum(axis=1) for i in range(64)])
    check(np.array_equal(np.asarray(distance.pairwise_hamming(jnp.asarray(rd))), want_h),
          "pairwise_hamming")
    # edit_distance_packed vs the native DP
    qs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (64, 150))]
    ts = qs.copy()
    for i in range(64):  # a few substitutions each
        pos = rng.integers(0, 150, 1 + i % 6)
        ts[i, pos] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, pos.size)]
    qw = jnp.asarray(np.stack([spec.u64_to_u32_pairs(native.n_to_bits(r)).reshape(-1) for r in qs]))
    tw = jnp.asarray(np.stack([spec.u64_to_u32_pairs(native.n_to_bits(r)).reshape(-1) for r in ts]))
    n150 = jnp.full(64, 150, jnp.int32)
    got_d = np.asarray(align.edit_distance_packed(qw, n150, tw, n150))
    want_d = np.array([native.edit_distance(qs[i], ts[i]) for i in range(64)])
    check(np.array_equal(got_d, want_d), "edit_distance_packed")
    log("  pairwise_hamming (64x4096) and edit_distance_packed (64 pairs) == oracle")


def phase_multi(seed: int) -> None:
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cute_nucleotides_jax import parallel
    from cute_nucleotides_jax.parallel import data_parallel, longseq
    from cute_nucleotides_jax.parallel.mesh import DATA_AXIS

    log("phase multi")
    devs = jax.devices()
    check(len(devs) == 4, f"--multi needs 4 devices, found {len(devs)}")
    mesh = parallel.make_mesh()
    rng = np.random.default_rng(seed + 4)

    def spread(arr, what):
        ids = sorted({s.device.id for s in arr.addressable_shards})
        check(len(ids) == 4, f"{what}: shards on devices {ids}, want all 4")

    B, L = 4096, 2048
    reads = np.frombuffer(b"ACGTacgtUu", np.uint8)[rng.integers(0, 10, (B, L))]
    x = jax.device_put(reads, NamedSharding(mesh, P(DATA_AXIS, None)))
    spread(x, "sharded reads")
    want = spec.u64_to_u32_pairs(native.n_to_bits(reads.reshape(-1))).reshape(B, -1)
    single = np.asarray(models.TwoBitCodec().encode(jax.device_put(reads, devs[0])))
    check(np.array_equal(single, want), "single-device encode != oracle")
    w_sh = parallel.data_parallel_encode(x)
    spread(w_sh, "data_parallel_encode output")
    w_g = parallel.data_parallel_encode(x, gather=True)
    check(np.array_equal(np.asarray(w_g), want), "data_parallel_encode gather")
    d_g = parallel.data_parallel_decode(w_sh, gather=True)
    check(np.array_equal(np.asarray(d_g), normalize(reads)), "data_parallel_decode gather")
    words, nbad = data_parallel.data_parallel_encode_checked(x)
    check(np.array_equal(np.asarray(words), want) and int(nbad) == 0, "encode_checked clean")
    poisoned = reads.copy()
    poisoned[3 * B // 4 + 5, 77] = ord("X")  # a row on the last shard
    _, nbad = data_parallel.data_parallel_encode_checked(
        jax.device_put(poisoned, NamedSharding(mesh, P(DATA_AXIS, None))))
    check(int(nbad) == 1, f"encode_checked psum flag = {int(nbad)}")
    log("  data_parallel encode/decode (gather) + checked psum: bit-exact, spread over 4 devices")

    # long sequence, block-sharded over the seq axis, + ppermute halo search
    smesh = parallel.make_mesh(data=1, seq=4)
    n = 20_000_000
    long2 = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    q = b"GATTACAGATTACA"
    bounds = [longseq.shard_points_2bit(n, 4)[k] - 5 for k in (1, 2, 3)]
    for p in bounds:  # hits straddling each shard boundary
        long2[p : p + len(q)] = np.frombuffer(q, np.uint8)
    got = longseq.encode_long_2bit(long2, mesh=smesh)
    want2 = native.n_to_bits(long2)
    check(np.array_equal(got, want2), "encode_long_2bit")
    check(bytes(longseq.decode_long_2bit(got, n, mesh=smesh)) == long2.tobytes(),
          "decode_long_2bit")
    pos = longseq.match_long(want2, n, q, mesh=smesh)
    want_pos = np_matches(long2, q, ord("N"))
    check(np.array_equal(pos, want_pos) and set(bounds) <= set(pos.tolist()),
          "match_long halo search")
    single_pos = search.match_positions(packed_2bit(long2), n, q)
    check(np.array_equal(pos, single_pos), "match_long != single-device scan")
    long5 = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, n)]
    got5 = longseq.encode_long_b5(long5, mesh=smesh)
    check(np.array_equal(got5, native.n_to_bits2(long5)), "encode_long_b5")
    q5 = bytes(long5[longseq.shard_points_b5(n, 4)[2] - 9 :][:20])
    pos5 = longseq.match_long_b5(got5, n, q5, mesh=smesh)
    check(np.array_equal(pos5, np_matches(long5, q5, ord("?"))), "match_long_b5 halo search")
    log(f"  longseq 2-bit/base-5 encode ({n} nt) + ppermute halo search: bit-exact")

    # spectrum, sketch and grep over the data axis
    lengths = rng.integers(1500, L + 1, B).astype(np.int32)
    wl = jax.device_put(want, NamedSharding(mesh, P(DATA_AXIS, None)))
    ln = jnp.asarray(lengths)
    sp = parallel.kmer_spectrum(wl, ln, 8)
    check(np.array_equal(np.asarray(sp),
                         np.asarray(kmer.kmer_histogram_batch(jnp.asarray(want), ln, 8))),
          "kmer_spectrum != single device")
    nr = normalize(reads)
    want_sp = np.zeros(4**8, np.int64)
    for r, m in zip(nr[:64], lengths[:64]):
        want_sp += np.bincount(np_codes(CODE2[r[:m]], 8).astype(np.int64), minlength=4**8)
    sp64 = parallel.kmer_spectrum(
        jax.device_put(want[:64], NamedSharding(mesh, P(DATA_AXIS, None))), ln[:64], 8)
    check(np.array_equal(np.asarray(sp64), want_sp), "kmer_spectrum != numpy")
    sk = parallel.sketch_sharded(wl, ln, 21, 1000)
    check(np.array_equal(np.asarray(sk),
                         np.asarray(sketch.bottom_k_sketch_batch(jnp.asarray(want), ln, 21, 1000))),
          "sketch_sharded != single device")
    mc = np.asarray(parallel.match_counts(wl, ln, b"GATTACA"))
    want_mc = np.array([np_matches(nr[i, : lengths[i]], b"GATTACA", ord("N")).size
                        for i in range(B)])
    check(np.array_equal(mc, want_mc), "match_counts != numpy")
    log("  kmer_spectrum / sketch_sharded / match_counts: == single device and numpy")


def main(argv=None) -> int:
    global CARD
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card mesh phase")
    args = p.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    compile_cache.enable()
    CARD = profiling.gpu_name_power().replace("\n", " | ")
    log(f"card: {CARD}")
    log(f"jax {jax.__version__}, devices: {len(jax.devices())} x {dev.device_kind}; "
        f"native oracle built: {native.available()}")
    check(native.available(), "native C++ oracle failed to build")
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(args.seed)
    else:
        for phase in (phase_kernels, phase_reach, phase_chromosome, phase_ingest):
            t = time.perf_counter()
            phase(args.seed)
            log(f"  ({phase.__name__} {time.perf_counter() - t:.1f} s)")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
