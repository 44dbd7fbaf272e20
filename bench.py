"""Benchmark harness: the reference's criterion table, measured on the device.

The reference benches 40,000-nt strings per call on one CPU core
(reference benches/bench_n_to_bits.rs:9-82) with a memcpy baseline and an
allocation-included policy.  Here the unit of work is a large resident batch
(32768 reads x 8192 nt = 256 MiB; 8208 nt per read for base-5), every op
allocates its output (XLA does so per call), an on-device copy is the
baseline, and the denominator is ASCII nucleotide bytes — the same
convention as the reference's ``group.throughput(Bytes(40000))``.

Timing: each row's time is the device-busy time of one call, read from a
profiler trace (sum of the call's kernel durations; ``utils.profiling``).
A backend whose trace carries no device events falls back to the host
clock around ``block_until_ready``; every row names its source.  Each row
also reports its share of the memory roofline against the card's published
peak (``utils.profiling.PEAKS``), and the card's ``name, power.limit``
heads the output.

Run on an accelerator: ``python bench.py``.  It refuses to run on the CPU
and raises on a device missing from the peak table.  Prints a human table
on stderr and exactly ONE JSON line on stdout, whose headline is the best
2-bit encode row, compared with the reference's champion single-core encode
(n_to_bits_movemask, 28.962 GiB/s, reference README.md:349).
"""

from __future__ import annotations

import functools
import json
import statistics
import sys
import tempfile
import time

import numpy as np

REF_BEST_ENCODE_GIBS = 28.962  # reference README.md:349 (n_to_bits_movemask)

ROWS = 32768
NT_PER_ROW = 8192          # % 16 == 0 (2-bit block)
NT_PER_ROW_B5 = 8208       # % 27 == 0 (base-5 block)
KMER_WORDS = 1 << 20       # 16.8 Mnt slice for the packed-domain rows
ITERS = 5

ENCODE_VARIANTS = ("mul", "shift", "interleave", "dot")
DECODE_VARIANTS = ("swar", "shuffle", "select", "broadcast")


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    import jax

    from cute_nucleotides_jax.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        _log("bench.py measures an accelerator; JAX found only the CPU")
        return 2
    import jax.numpy as jnp

    from cute_nucleotides_jax.ops import kmer, native, search, seqops, xla
    from cute_nucleotides_jax.utils import profiling

    hbm = profiling.peaks(dev.device_kind)["hbm_bytes_per_s"]
    card = profiling.gpu_name_power()
    _log(f"device {dev.platform} {dev.device_kind} x{len(jax.devices())}; card: {card}")
    trace_dir = tempfile.mkdtemp(prefix="bench_trace_")
    rows: list[dict] = []

    def run(name, fn, *args, nt, roofline=None):
        f = jax.jit(fn)
        s = profiling.measure_device_seconds(
            f, *args, iters=ITERS, log_dir=trace_dir
        )
        source = "device-trace"
        if s is None:
            ts = []
            for _ in range(ITERS):
                t0 = time.perf_counter()
                jax.block_until_ready(f(*args))
                ts.append(time.perf_counter() - t0)
            s, source = statistics.median(ts), "host-clock"
        row = {"name": name, "s": s, "gibs": nt / s / 2**30, "source": source}
        if roofline is not None:
            row["roofline_share"] = roofline.efficiency(s, hbm)
        rows.append(row)
        share = row.get("roofline_share")
        _log(
            f"{name:30s} {s * 1e3:10.4f} ms {row['gibs']:9.1f} GiB/s "
            + (f"{share:6.1%} of HBM " if share is not None else "")
            + source
        )

    key = jax.random.PRNGKey(0)
    lut2 = jnp.asarray(np.frombuffer(b"ACGTacgt", np.uint8))
    lut5 = jnp.asarray(np.frombuffer(b"ACGTNacgtn", np.uint8))
    x2 = jax.jit(lambda k: lut2[jax.random.randint(k, (ROWS, NT_PER_ROW), 0, 8)])(key)
    x5 = jax.jit(lambda k: lut5[jax.random.randint(k, (ROWS, NT_PER_ROW_B5), 0, 10)])(key)
    nt2, nt5 = x2.size, x5.size

    run("device_copy_u8", lambda a: a ^ jnp.uint8(1), x2, nt=nt2,
        roofline=profiling.Roofline(nt2, nt2))
    for v in ENCODE_VARIANTS:
        run(f"encode_2bit_{v}", functools.partial(xla.encode_2bit_words, variant=v),
            x2, nt=nt2, roofline=profiling.encode_2bit_roofline(nt2))
    run("encode_2bit_checked", xla.encode_2bit_words_checked, x2, nt=nt2,
        roofline=profiling.encode_2bit_roofline(nt2))
    w2 = jax.jit(xla.encode_2bit_words)(x2)
    for v in DECODE_VARIANTS:
        run(f"decode_2bit_{v}", functools.partial(xla.decode_2bit_bytes, variant=v),
            w2, nt=nt2, roofline=profiling.decode_2bit_roofline(nt2))
    run("encode_b5", xla.encode_b5_words, x5, nt=nt5,
        roofline=profiling.encode_b5_roofline(nt5))
    run("encode_b5_checked", xla.encode_b5_words_checked, x5, nt=nt5,
        roofline=profiling.encode_b5_roofline(nt5))
    w5 = jax.jit(xla.encode_b5_words)(x5)
    run("decode_b5", xla.decode_b5_bytes, w5, nt=nt5,
        roofline=profiling.decode_b5_roofline(nt5))
    run("decode_b5_checked",
        lambda w: (xla.decode_b5_bytes(w), jnp.any(seqops.first_invalid_word_b5(w) >= 0)),
        w5, nt=nt5, roofline=profiling.decode_b5_roofline(nt5))

    # packed-domain analytics on a 16.8 Mnt slice of the encoded batch
    kw = w2.reshape(-1)[:KMER_WORDS]
    kl = 16 * KMER_WORDS
    run("kmer_histogram_k8", lambda w: kmer.kmer_histogram(w, kl, 8), kw, nt=kl)
    run("kmer_counts_k21", lambda w: kmer.kmer_counts(w, kl, 21, canonical=True),
        kw, nt=kl)
    run("minimizer_bits_k15_w10", lambda w: kmer.minimizer_bits(w, kl, 15, 10),
        kw, nt=kl)
    run("match_count_7nt", lambda w: search.match_count(w, kl, b"ACGTNGT"), kw, nt=kl)
    run("revcomp_2bit", lambda w: seqops.revcomp_packed(w, kl), kw, nt=kl,
        roofline=profiling.Roofline(kl // 4, kl // 4))
    b5w = w5.reshape(-1)[: 2 * (KMER_WORDS // 2)]
    b5n = 27 * (b5w.size // 2)
    run("gc_content_b5", seqops.gc_content_packed_b5, b5w, nt=b5n,
        roofline=profiling.Roofline(b5w.size * 4, 0))

    # host-native C++ oracle rows (the reference's scalar-tier analogue)
    hb = np.asarray(x2[:1024]).reshape(-1)
    for name, fn in (
        ("host_memcpy", lambda: native.memcpy(hb)),
        ("host_oracle_encode", lambda: native.n_to_bits(hb)),
    ):
        fn()
        ts = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        s = statistics.median(ts)
        rows.append({"name": name, "s": s, "gibs": hb.size / s / 2**30,
                     "source": "host-clock"})
        _log(f"{name:30s} {s * 1e3:10.4f} ms {hb.size / s / 2**30:9.1f} GiB/s host-clock")

    best = max(
        (r for r in rows if r["name"].startswith("encode_2bit_")
         and r["name"] != "encode_2bit_checked"),
        key=lambda r: r["gibs"],
    )
    print(json.dumps({
        "metric": f"2-bit encode throughput, device time ({best['name']}, "
                  f"{ROWS}x{NT_PER_ROW} nt batch)",
        "value": best["gibs"],
        "unit": "GiB/s",
        "vs_baseline": best["gibs"] / REF_BEST_ENCODE_GIBS,
        "roofline_share": best["roofline_share"],
        "timing_source": best["source"],
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "rows": {r["name"]: r["gibs"] for r in rows},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
