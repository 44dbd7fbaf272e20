"""Streaming IO, checkpoint manifest, metrics, validation pass, runtime."""

import gzip
import io as pyio
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from cute_nucleotides_jax.ops import oracle, spec, validate
from cute_nucleotides_jax.parallel import runtime
from cute_nucleotides_jax.utils import checkpoint, io, metrics, profiling


# --- readers ----------------------------------------------------------------

def test_fasta_reader():
    data = b">r1 desc\nACGT\nACGT\n>r2\nTTTT\n"
    recs = list(io.read_fasta(pyio.BytesIO(data)))
    assert [r.name for r in recs] == [b"r1 desc", b"r2"]
    assert [r.seq for r in recs] == [b"ACGTACGT", b"TTTT"]


def test_fastq_reader():
    data = b"@r1\nACGT\n+\n!!!!\n@r2\nGGGG\n+\nIIII\n"
    recs = list(io.read_fastq(pyio.BytesIO(data)))
    assert [r.seq for r in recs] == [b"ACGT", b"GGGG"]


def test_fastq_malformed():
    with pytest.raises(ValueError):
        list(io.read_fastq(pyio.BytesIO(b"ACGT\nACGT\n+\n!!!!\n")))


def test_open_reads_gz(tmp_path):
    p = tmp_path / "reads.fa.gz"
    with gzip.open(p, "wb") as f:
        f.write(b">a\nACGT\n")
    recs = list(io.open_reads(p))
    assert recs[0].seq == b"ACGT"


def test_shard_records():
    recs = [io.Record(str(i).encode(), b"A") for i in range(10)]
    got = list(io.shard_records(recs, host_id=1, num_hosts=3))
    assert [i for i, _ in got] == [1, 4, 7]


# --- batch stream -----------------------------------------------------------

def test_batch_stream_shapes_and_padding():
    recs = [io.Record(b"", b"ACGT" * k) for k in (1, 3, 9, 2, 5)]
    batches = list(io.BatchStream(recs, batch_size=2, max_len=40, block=32))
    assert len(batches) == 3
    assert all(b.reads.shape == (2, 64) for b in batches)  # 40 -> 64 (block)
    assert batches[0].lengths.tolist() == [4, 12]
    assert batches[-1].count == 1
    assert batches[-1].indices.tolist() == [-1, -1]  # plain records: no ids
    assert bytes(batches[0].reads[0][:8]) == b"ACGTAAAA"


def test_batch_stream_skip_resume():
    recs = [io.Record(b"", b"ACGT")] * 6
    all_b = list(io.BatchStream(recs, batch_size=2, max_len=32))
    resumed = list(io.BatchStream(recs, batch_size=2, max_len=32, skip=2))
    assert len(all_b) == 3 and len(resumed) == 1


def test_batch_stream_too_long():
    recs = [io.Record(b"", b"A" * 100)]
    with pytest.raises(ValueError):
        list(io.BatchStream(recs, batch_size=1, max_len=32))
    b = next(iter(io.BatchStream(recs, batch_size=1, max_len=32, truncate=True)))
    assert b.lengths[0] == 32
    # the raise fires BEFORE further records are consumed from the
    # caller's iterator (r05 review: batch-assembly-time validation lost
    # up to batch_size-1 records) and inside skipped batches too
    it = iter([io.Record(b"", b"A" * 100), io.Record(b"", b"ACGT")])
    with pytest.raises(ValueError, match="exceeds max_len"):
        next(iter(io.BatchStream(it, batch_size=8, max_len=32)))
    assert next(it).seq == b"ACGT"  # second record untouched
    with pytest.raises(ValueError, match="exceeds max_len"):
        list(
            io.BatchStream(
                [io.Record(b"", b"A" * 100)] * 4,
                batch_size=2,
                max_len=32,
                skip=5,
            )
        )


# --- checkpoint manifest ----------------------------------------------------

def test_manifest_roundtrip(tmp_path):
    p = tmp_path / "manifest.json"
    m = checkpoint.Manifest(p)
    m.advance(0, batches=3, records=100)
    m.advance(1, batches=2, records=64)
    m.save()
    m2 = checkpoint.Manifest(p)
    assert m2.batches_done(0) == 3 and m2.records_done(1) == 64
    assert m2.batches_done(9) == 0


def test_manifest_shared_path_merges_hosts(tmp_path):
    """Two host processes saving to the SAME manifest path must not
    clobber each other's positions (r05 review: a blind rewrite dropped
    the other host's entry, re-delivering its whole stream on resume)."""
    p = tmp_path / "manifest.json"
    host_a = checkpoint.Manifest(p)  # opened before host_b ever saved
    host_b = checkpoint.Manifest(p)
    host_a.advance(0, batches=5, records=500)
    host_a.save()
    host_b.advance(1, batches=7, records=700)
    host_b.save()  # must merge, not drop, host 0's entry
    merged = checkpoint.Manifest(p)
    assert merged.batches_done(0) == 5
    assert merged.batches_done(1) == 7
    # a host's own later save still wins over its stale on-disk entry
    host_a.advance(0, batches=1)
    host_a.save()
    assert checkpoint.Manifest(p).batches_done(0) == 6
    assert checkpoint.Manifest(p).batches_done(1) == 7


# --- metrics ----------------------------------------------------------------

def test_throughput_logger():
    buf = pyio.StringIO()
    log = metrics.ThroughputLogger(name="t", stream=buf, log_every=1)
    log.start()
    log.batch_done(nt=1000, reads=10)
    log.batch_done(nt=2000, reads=20)
    agg = log.aggregate()
    assert agg["total_nt"] == 3000 and agg["total_reads"] == 30
    lines = [json.loads(l) for l in buf.getvalue().splitlines()]
    assert len(lines) == 2 and lines[0]["event"] == "batch"
    assert metrics.scaling_efficiency(10.0, 4, 40.0) == 1.0


def test_roofline():
    r = profiling.encode_2bit_roofline(1 << 30)
    assert r.total == (1 << 30) + (1 << 28)
    assert 0 < r.memory_s(3.35e12) < 1


# --- device-side validation -------------------------------------------------

def test_validate_mask():
    x = jnp.asarray(np.frombuffer(b"ACGTUacgtuNnX", np.uint8))
    m = np.asarray(validate.valid_mask(x))
    assert m[:10].all() and not m[10] and not m[11] and not m[12]
    mn = np.asarray(validate.valid_mask(x, allow_n=True))
    assert mn[:12].all() and not mn[12]


def test_validate_first_invalid():
    x = jnp.asarray(np.frombuffer(b"ACGTXACGT", np.uint8))
    assert int(validate.jit_first_invalid()(x)) == 4
    ok = jnp.asarray(np.frombuffer(b"ACGT", np.uint8))
    assert int(validate.jit_first_invalid()(ok)) == -1
    batch = jnp.asarray(
        np.frombuffer(b"ACGTNNNNXAAA", np.uint8).reshape(3, 4)
    )
    got = np.asarray(validate.jit_first_invalid(allow_n=True)(batch))
    assert got.tolist() == [-1, -1, 0]
    assert int(validate.jit_count_invalid()(jnp.asarray(np.frombuffer(b"NXNA", np.uint8)))) == 3


# --- streaming runtime ------------------------------------------------------

def test_streaming_encoder_end_to_end(tmp_path):
    info = runtime.initialize()
    assert info["process_count"] == 1

    reads = [b"ACGTACGTacgtacgtUUUU", b"GGGGCCCC", b"ACGT" * 40]
    records = [io.Record(str(i).encode(), s) for i, s in enumerate(reads)]

    outputs = []
    enc = runtime.StreamingEncoder(
        batch_size=8,
        max_len=192,
        manifest_path=str(tmp_path / "m.json"),
    )
    agg = enc.run(records, sink=lambda w, b: outputs.append((w, b)))
    assert agg["total_reads"] == 3
    assert agg["total_nt"] == sum(len(r) for r in reads)
    (words, batch), = outputs
    for i, r in enumerate(reads):
        want = oracle.n_to_bits_lut(np.frombuffer(r, np.uint8))
        got = spec.u32_pairs_to_u64(words[i])[: want.size]
        assert np.array_equal(got, want)

    # resume: manifest records 1 batch done -> re-run consumes nothing
    enc2 = runtime.StreamingEncoder(
        batch_size=8,
        max_len=192,
        manifest_path=str(tmp_path / "m.json"),
    )
    agg2 = enc2.run(records, sink=lambda w, b: outputs.append((w, b)))
    assert agg2["batches"] == 0 and len(outputs) == 1


def test_profiler_trace_smoke(tmp_path):
    import jax.numpy as jnp2

    with profiling.trace(str(tmp_path / "trace")):
        jnp2.arange(8).sum().block_until_ready()
    # a trace directory with at least one artifact must exist
    import os

    found = any(files for _, _, files in os.walk(tmp_path / "trace"))
    assert found


def test_streaming_crash_resume_no_loss_no_dup(tmp_path):
    """Failure recovery contract (SURVEY §5): a crash mid-stream resumes from
    the manifest with no batch lost.  Delivery is at-least-once (the sink
    runs before the manifest advances); here the crash happens *inside* the
    sink — before any durable effect — so the re-delivered batch appears
    once.  A crash after a durable sink but before the manifest write would
    re-deliver, which idempotent sinks absorb (see parallel/runtime.py)."""
    reads = [b"ACGT" * (i % 5 + 1) for i in range(20)]
    records = [io.Record(str(i).encode(), s) for i, s in enumerate(reads)]
    manifest = str(tmp_path / "m.json")

    delivered = []

    class Boom(Exception):
        pass

    def crashing_sink(words, batch):
        if len(delivered) == 1:
            raise Boom()  # crash after one durable batch
        delivered.append(sorted(int(i) for i in batch.indices if i >= 0))

    # batch_size must divide by the data-axis size (8 virtual devices here)
    enc = runtime.StreamingEncoder(
        batch_size=8, max_len=64, manifest_path=manifest
    )
    with pytest.raises(Boom):
        enc.run(records, sink=crashing_sink)
    # one batch was durably recorded before the crash
    assert checkpoint.Manifest(manifest).batches_done(0) == 1

    enc2 = runtime.StreamingEncoder(
        batch_size=8, max_len=64, manifest_path=manifest
    )
    enc2.run(
        records,
        sink=lambda w, b: delivered.append(
            sorted(int(i) for i in b.indices if i >= 0)
        ),
    )
    flat = sorted(i for batch in delivered for i in batch)
    assert flat == list(range(20)), flat  # exactly once each


def test_streaming_decoder_roundtrip(tmp_path):
    """StreamingDecoder mirrors StreamingEncoder: packed entries stream back
    to exact-length reads, with manifest crash-resume (at-least-once)."""
    from cute_nucleotides_jax.ops import oracle
    from cute_nucleotides_jax.parallel import runtime

    rng = np.random.default_rng(3)
    seqs = [
        bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))
        for n in (1, 33, 100, 64, 31, 7, 200, 16, 42, 5)
    ]
    entries = [
        (b"r%d" % i, len(s), oracle.n_to_bits_lut(np.frombuffer(s, np.uint8)))
        for i, s in enumerate(seqs)
    ]
    got = {}
    dec = runtime.StreamingDecoder(batch_size=8, max_len=256)
    agg = dec.run(entries, sink=lambda name, seq: got.__setitem__(name, seq))
    assert got == {b"r%d" % i: s for i, s in enumerate(seqs)}
    assert agg["total_reads"] == len(seqs)

    # crash after the first durable batch -> resume skips it, no loss
    manifest = str(tmp_path / "d.json")
    seen = []

    class Boom(Exception):
        pass

    def crashing(name, seq):
        if len(seen) == 8:
            raise Boom()
        seen.append(name)

    dec2 = runtime.StreamingDecoder(
        batch_size=8, max_len=256, manifest_path=manifest
    )
    with pytest.raises(Boom):
        dec2.run(entries, sink=crashing)
    dec3 = runtime.StreamingDecoder(
        batch_size=8, max_len=256, manifest_path=manifest
    )
    got2 = {}
    dec3.run(entries, sink=lambda name, seq: got2.__setitem__(name, seq))
    # batch 0 was durably recorded; resume delivers only the remainder
    assert set(got2) == {b"r8", b"r9"}
    assert got2[b"r9"] == seqs[9]


def test_parse_device_durations(tmp_path):
    """The profiler parser extracts per-module device durations (the bench
    harness's ground-truth timing source)."""
    import jax
    import jax.numpy as jnp2

    f = jax.jit(lambda x: x * 2 + 1)
    x = jnp2.arange(1024.0)
    jax.block_until_ready(f(x))
    d = str(tmp_path / "t")
    with profiling.trace(d):
        for _ in range(4):
            r = f(x)
        jax.block_until_ready(r)
    by_name = profiling.parse_device_durations(d)
    # CPU backends may not emit device events; when they do, the jitted
    # module must appear with >= 2 executions and positive durations
    if by_name:
        name, durs = max(by_name.items(), key=lambda kv: len(kv[1]))
        assert all(t > 0 for t in durs)


def test_parse_device_durations_uses_device_busy_field():
    """The parser reads each kernel's own device duration from a recorded
    H100 trace (three calls of the 2-bit "mul" encode on a 32768 x 8192
    batch: one fused kernel each, ~0.108 ms), not host-thread spans."""
    import pathlib

    d = pathlib.Path(__file__).parent / "data" / "h100_encode_trace"
    out = profiling.parse_device_durations(str(d))
    assert set(out) == {"loop_convert_fusion"}
    durs = out["loop_convert_fusion"]
    assert len(durs) == 3
    assert all(100e-6 < t < 120e-6 for t in durs), durs


def test_fastq_batches_matches_batchstream(tmp_path, rng):
    """The vectorized FASTQ->Batch assembler is bit-identical to the
    Record/BatchStream path (ragged lengths, chunk-boundary carry, skip)."""
    parts = []
    for i in range(533):
        L = int(rng.integers(0, 120))
        s = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), L))
        q = bytes(rng.integers(33, 105, L).astype(np.uint8))  # incl '@', '+'
        parts.append(b"@r%d meta\n" % i + s + b"\n+\n" + q + b"\n")
    fq = tmp_path / "t.fastq"
    fq.write_bytes(b"".join(parts))
    for skip in (0, 2):
        a = list(
            io.fastq_batches(str(fq), 64, 120, skip=skip, chunk_bytes=4096)
        )
        b = list(
            io.BatchStream(io.read_fastq(str(fq)), 64, 120, skip=skip)
        )
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.count == y.count
            assert np.array_equal(x.reads, y.reads)
            assert np.array_equal(x.lengths, y.lengths)


def test_fill_rows_native_matches_fallback(rng, monkeypatch):
    """ops.native.fill_rows: C path == NumPy fallback (ragged, truncation,
    pad rows), and out-of-bounds spans are rejected before reaching C."""
    from cute_nucleotides_jax.ops import native

    buf = rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8), 4096)
    starts = rng.integers(0, 3800, 37).astype(np.int64)
    lens = rng.integers(0, 300, 37).astype(np.int64)  # some exceed width 128
    out_native = np.full((48, 128), 0xEE, np.uint8)
    native.fill_rows(buf, starts, lens, out_native)
    out_fb = np.full((48, 128), 0xEE, np.uint8)
    monkeypatch.setattr(native, "_lib", lambda: None)
    native.fill_rows(buf, starts, lens, out_fb)
    assert np.array_equal(out_native, out_fb)
    assert np.all(out_native[37:] == ord("A"))
    monkeypatch.undo()

    if native.available():
        with pytest.raises(ValueError, match="out of buffer bounds"):
            native.fill_rows(
                buf,
                np.array([4090], np.int64),
                np.array([100], np.int64),
                np.empty((1, 128), np.uint8),
            )
        with pytest.raises(ValueError, match="reads for"):
            native.fill_rows(
                buf,
                np.zeros(3, np.int64),
                np.zeros(3, np.int64),
                np.empty((2, 8), np.uint8),
            )


def test_fastq_batches_fallback_matches_native(tmp_path, rng, monkeypatch):
    """fastq_batches emits identical batches with and without the C fill."""
    from cute_nucleotides_jax.ops import native

    parts = []
    for i in range(150):
        L = int(rng.integers(0, 90))
        s = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), L))
        parts.append(b"@r%d\n" % i + s + b"\r\n+\n" + b"I" * L + b"\n")
    fq = tmp_path / "t.fastq"
    fq.write_bytes(b"".join(parts))
    a = list(io.fastq_batches(str(fq), 32, 96))
    monkeypatch.setattr(native, "_lib", lambda: None)
    b = list(io.fastq_batches(str(fq), 32, 96))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.count == y.count
        assert np.array_equal(x.reads, y.reads)
        assert np.array_equal(x.lengths, y.lengths)
        assert np.array_equal(x.indices, y.indices)


def test_streaming_encoder_run_batches(tmp_path, rng):
    """run_batches (the fastq_batches fast path) delivers the same packed
    words as run() and honors the manifest resume contract."""
    parts = []
    reads = []
    for i in range(37):
        s = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 64))
        reads.append(s)
        parts.append(b"@r%d\n" % i + s + b"\n+\nI\n")
    fq = tmp_path / "r.fastq"
    fq.write_bytes(b"".join(parts))

    outputs = []
    enc = runtime.StreamingEncoder(
        batch_size=8, max_len=64, manifest_path=str(tmp_path / "m.json")
    )
    agg = enc.run_batches(
        io.fastq_batches(str(fq), 8, 64),
        sink=lambda w, b: outputs.append((w.copy(), b)),
    )
    assert agg["total_reads"] == 37
    seen = 0
    for words, batch in outputs:
        for row in range(batch.count):
            want = oracle.n_to_bits_lut(np.frombuffer(reads[seen], np.uint8))
            got = spec.u32_pairs_to_u64(words[row])[: want.size]
            assert np.array_equal(got, want)
            seen += 1
    assert seen == 37

    # resume: 5 batches durably recorded -> nothing re-consumed
    enc2 = runtime.StreamingEncoder(
        batch_size=8, max_len=64, manifest_path=str(tmp_path / "m.json")
    )
    agg2 = enc2.run_batches(
        io.fastq_batches(str(fq), 8, 64), sink=lambda w, b: outputs.append(1)
    )
    assert agg2["batches"] == 0 and len(outputs) == 5


def test_roofline_memory_bound():
    """Codec rooflines: least time = bytes / bandwidth; efficiency is the
    share of it a measured time reaches."""
    r = profiling.encode_2bit_roofline(2**30)  # 1 GiB in, 256 MiB out
    assert r.total == 2**30 + 2**28
    hbm = profiling.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"]
    assert r.memory_s(hbm) == pytest.approx((2**30 + 2**28) / 3.35e12)
    assert r.efficiency(r.memory_s(hbm), hbm) == pytest.approx(1.0)
    assert r.efficiency(2 * r.memory_s(hbm), hbm) == pytest.approx(0.5)
    assert profiling.decode_b5_roofline(27 * 8).total == 8 * 8 + 27 * 8


def test_peaks_table_h100():
    row = profiling.peaks("NVIDIA H100 80GB HBM3")
    assert row == {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12}


def test_bench_refuses_cpu():
    """bench.py measures an accelerator: on the CPU it exits non-zero and
    prints no result line."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    p = subprocess.run(
        [sys.executable, str(root / "bench.py")],
        capture_output=True, text=True, env=env, timeout=120, cwd=root,
    )
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "only the CPU" in p.stderr


def test_peaks_raise_on_unknown_device():
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.peaks("Some Future Accelerator")
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.peaks("cpu")


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins as it stands; without it the cache
    sits at the fixed <checkout>/.jax_cache."""
    import pathlib

    import jax

    from cute_nucleotides_jax.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before  # nothing set here
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    root = pathlib.Path(__file__).resolve().parents[1]
    try:
        assert compile_cache.enable() == str(root / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(root / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_timing_without_device_events(tmp_path):
    """On a backend whose trace holds no device plane (the CPU) the
    profiler timing reports None, so callers fall back to the host clock
    and say so; a missing capture parses to no kernels."""
    import jax
    import jax.numpy as jnp

    assert profiling.parse_device_durations(str(tmp_path / "none")) == {}
    f = jax.jit(lambda x: x + 1)
    got = profiling.measure_device_seconds(
        f, jnp.zeros(8), iters=2, log_dir=str(tmp_path / "tr")
    )
    assert got is None


def test_streaming_decoder_verify():
    """verify=True rides the checked decode: clean base-5 streams
    decode normally; a corrupt word raises with the diagnosed record before
    anything is sunk; 2-bit verify is rejected at construction."""
    from cute_nucleotides_jax.ops import oracle as orc
    from cute_nucleotides_jax.parallel import runtime as rt

    rng = np.random.default_rng(11)
    seqs = [
        bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), n))
        for n in (27, 54, 13, 100, 7, 81, 40, 64, 9, 120)
    ]
    entries = [
        (b"r%d" % i, len(s), orc.n_to_bits2_lut(np.frombuffer(s, np.uint8)))
        for i, s in enumerate(seqs)
    ]
    got = {}
    dec = rt.StreamingDecoder(batch_size=8, max_len=128, codec="base5", verify=True)
    dec.run(entries, sink=lambda name, seq: got.__setitem__(name, seq))
    assert got == {b"r%d" % i: s for i, s in enumerate(seqs)}

    bad_entries = [(n, l, w.copy()) for n, l, w in entries]
    bad_entries[4][2][0] |= np.uint64(1) << np.uint64(63)  # r4's pad bit
    sunk = []
    dec2 = rt.StreamingDecoder(batch_size=8, max_len=128, codec="base5", verify=True)
    with pytest.raises(ValueError, match="corrupt base-5 word 0 in record r4"):
        dec2.run(bad_entries, sink=lambda name, seq: sunk.append(name))
    assert b"r4" not in sunk  # the corrupt batch was never sunk

    with pytest.raises(ValueError, match="base-5 only"):
        rt.StreamingDecoder(codec="2bit", verify=True)


def test_streaming_encoder_validate():
    """validate=True rides the checked encode: clean inputs stream
    normally (both codecs); an out-of-alphabet byte raises with position +
    record index before the batch is sunk."""
    from cute_nucleotides_jax.parallel import runtime as rt
    from cute_nucleotides_jax.utils import io as io_lib

    rng = np.random.default_rng(13)
    for codec, alpha in (("2bit", b"ACGTUacgtu"), ("base5", b"ACGTUNacgtun")):
        seqs = [
            rng.choice(np.frombuffer(alpha, np.uint8), n).tobytes()
            for n in (8, 33, 100, 64, 31, 7, 200, 16)
        ]
        records = [io_lib.Record(b"r%d" % i, s) for i, s in enumerate(seqs)]
        sunk = []
        enc = rt.StreamingEncoder(
            batch_size=8, max_len=256, codec=codec, validate=True
        )
        agg = enc.run(records, sink=lambda w, b: sunk.append(b.count))
        assert agg["total_reads"] == len(seqs) and sunk == [8]

        bad = list(seqs)
        bad[5] = bad[5][:3] + b"@" + bad[5][4:]
        records = [io_lib.Record(b"r%d" % i, s) for i, s in enumerate(bad)]
        sunk2 = []
        enc2 = rt.StreamingEncoder(
            batch_size=8, max_len=256, codec=codec, validate=True
        )
        with pytest.raises(ValueError, match="invalid byte b'@'.*record index 5"):
            enc2.run(records, sink=lambda w, b: sunk2.append(b.count))
        assert sunk2 == []  # nothing delivered from the poisoned batch
