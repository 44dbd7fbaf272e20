"""Multi-host distributed runtime: cluster initialization + streaming pipeline.

The reference is a single-threaded, in-process library; this build promotes
it to a multi-host service (SURVEY.md §2.3):

* :func:`initialize` wraps ``jax.distributed.initialize`` (no-op on a single
  host) and reports the host topology.
* :class:`StreamingEncoder` is the full production loop: host-sharded record
  stream -> fixed-shape padded batches -> data-parallel sharded encode on the
  local mesh -> (optional) all_gather merge -> sink callback, with
  per-batch metrics and a resumable stream-position manifest.  Because the
  codec is stateless, failure recovery is re-dispatching batches from the
  manifest position — there is no model state to restore.

Delivery semantics: **at-least-once**.  The sink runs *before* the manifest
advances (a manifest must never claim un-sunk work), so a crash in the window
between a successful sink and the manifest write re-delivers that batch on
resume.  Sinks must therefore be idempotent per ``batch.index`` (e.g. write
to a per-batch path, or upsert keyed on the batch index); no batch is ever
lost or skipped.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import checkpoint as ckpt_lib
from ..utils import io as io_lib
from ..utils import metrics as metrics_lib
from . import data_parallel, mesh as mesh_lib


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Initialize the multi-host runtime; safe no-op for a single process.

    On a cluster, call with the coordinator address, process count and
    process id before any JAX computation.
    """
    if coordinator_address is not None or (
        num_processes is not None and num_processes > 1
    ):
        # a coordinator address alone must NOT silently no-op (r05
        # review: every host would then believe it is a 1-host cluster and
        # consume the full record stream); jax.distributed auto-detects
        # whatever arguments are omitted
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def _prefetch(
    iterable: Iterable, depth: int = 1, stages: dict | None = None
) -> Iterator:
    """Run ``iterable`` in a background thread, ``depth`` items ahead.

    The host-side batch prep (record padding/packing) is pure NumPy and
    releases the GIL in its hot copies, so the prefetch overlaps prep of
    batch N+depth with the device encode of batch N (the pipeline overlap
    a serial loop lacks).  Exceptions from the
    producer re-raise at the consumption point; the queue depth bounds
    host memory to ``depth + 1`` in-flight batches.  When ``stages`` is
    given, time the consumer spends *blocked* on the producer accumulates
    into ``stages["prep_wait_s"]`` — nonzero means host parse/assembly is
    not hidden by the pipeline.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    failure: list[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that gives up when the consumer abandoned the
        # generator (r05 review: an unconditional q.put pinned the
        # thread + the open input stream forever after a pipeline abort)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            failure.append(e)
        finally:
            _put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if stages is not None:
                stages["prep_wait_s"] += time.perf_counter() - t0
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()


def _pipelined(
    items: Iterator,
    dispatch: Callable,
    finish: Callable,
    *,
    readback_depth: int,
    stages: dict,
) -> None:
    """Drive the dispatch/finish halves of a streaming pipeline with the
    finish half on its own thread.

    ``dispatch(item)`` issues the device work (H2D + kernel, async) and
    returns a pending token; ``finish(pending)`` blocks on the readback
    and runs sink/accounting.  Running finish on a worker thread lets the
    D2H of batch N overlap the H2D of batch N+1 on a full-duplex host
    link — the main thread never blocks on readback, so
    upload keeps streaming.  A single worker preserves batch order (the
    manifest's at-least-once contract needs in-order advancement); the
    bounded queue holds ``readback_depth`` batches of device output alive.
    Worker exceptions re-raise here after an orderly drain; a failed
    finish never lets later batches sink (the worker discards them).
    """
    fq: queue.Queue = queue.Queue(maxsize=max(readback_depth, 1))
    sentinel = object()
    failure: list[BaseException] = []

    def worker():
        while True:
            item = fq.get()
            if item is sentinel:
                return
            if failure:
                continue  # drain without sinking past a failure
            try:
                t0 = time.perf_counter()
                finish(item)
                stages["finish_s"] += time.perf_counter() - t0
            except BaseException as e:
                failure.append(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        for item in items:
            if failure:
                break
            t0 = time.perf_counter()
            pending = dispatch(item)
            stages["dispatch_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            fq.put(pending)
            stages["backpressure_s"] += time.perf_counter() - t0
    finally:
        fq.put(sentinel)
        t.join()
        # explicitly close the (usually _prefetch) generator: an abort's
        # exception traceback can keep it referenced, so relying on GC
        # would leave its producer thread running (r05 review)
        close = getattr(items, "close", None)
        if close is not None:
            close()
    if failure:
        raise failure[0]


def _new_stages() -> dict:
    """Per-stage wall-second accumulators for the pipeline attribution.

    ``prep_wait_s`` — main thread blocked on host parse/assembly;
    ``dispatch_s`` — main thread inside device_put + jit dispatch (the
    synchronous slice of H2D through the link); ``backpressure_s`` — main
    thread blocked because the readback worker is behind (D2H + sink are
    the bottleneck); ``finish_s``/``readback_s``/``sink_s``/``manifest_s``
    — worker-thread time (overlapped with dispatch, so these bound but do
    not sum into the wall).  ``prep_wait + dispatch + backpressure ~ wall``
    attributes the critical path.
    """
    return {
        "prep_wait_s": 0.0,
        "dispatch_s": 0.0,
        "backpressure_s": 0.0,
        "finish_s": 0.0,
        "readback_s": 0.0,
        "sink_s": 0.0,
        "manifest_s": 0.0,
    }


@dataclasses.dataclass
class StreamConfig:
    batch_size: int = 1024
    max_len: int = 2048
    codec: str = "2bit"
    tier: str = "auto"
    variant: str | None = None  # None -> the tier's fastest variant
    gather: bool = False
    manifest_path: str | None = None
    log_every: int = 0
    allow_truncate: bool = False
    #: decode-side stream-integrity verification (base-5 only): the check
    #: compiles into the decode's own program; a corrupt batch
    #: raises before anything is sunk or the manifest advances
    verify: bool = False
    #: encode-side input validation (both codecs): the check compiles into
    #: the encode's own program; a batch containing a byte
    #: outside the codec's alphabet raises before anything is sunk
    validate: bool = False
    #: host-prep batches assembled ahead of the device (pipeline stage 1)
    prefetch_depth: int = 2
    #: device-output batches the readback worker may hold in flight
    #: (pipeline stage 3); 2 keeps D2H of batch N overlapping H2D of N+2
    readback_depth: int = 2


class StreamingEncoder:
    """Cluster-wide streaming encode pipeline over per-host record streams."""

    def __init__(self, config: StreamConfig | None = None, **overrides):
        if config is None:
            config = StreamConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.host_id = jax.process_index()
        self.num_hosts = jax.process_count()
        # the pipeline is collective-free across hosts (records are sharded
        # host-side), so the device mesh spans only this host's devices
        self.mesh = mesh_lib.make_mesh(devices=jax.local_devices())
        self.sharded = data_parallel.ShardedCodec(
            config.codec,
            mesh=self.mesh,
            variant=config.variant,
            tier=config.tier,
        )
        block = 32 if config.codec == "2bit" else 27
        self.block = block
        self.logger = metrics_lib.ThroughputLogger(
            name=f"stream-encode-h{self.host_id}", log_every=config.log_every
        )
        self.manifest = (
            ckpt_lib.Manifest(config.manifest_path)
            if config.manifest_path
            else None
        )

    def run(
        self,
        records: Iterable[io_lib.Record],
        sink: Callable[[np.ndarray, io_lib.Batch], None] | None = None,
    ) -> dict:
        """Consume this host's shard of ``records``; return aggregate metrics.

        ``sink(packed_words, batch)`` receives each encoded batch (host
        NumPy u32 words and the batch metadata including true lengths).
        Resumes from the manifest position when one is configured.
        """
        cfg = self.config
        skip = self.manifest.batches_done(self.host_id) if self.manifest else 0
        sharded_records = io_lib.shard_records(
            records, self.host_id, self.num_hosts
        )
        stream = io_lib.BatchStream(
            sharded_records,
            cfg.batch_size,
            cfg.max_len,
            block=self.block,
            truncate=cfg.allow_truncate,
            skip=skip,
        )
        return self.run_batches(stream, sink, _skip_applied=True)

    def run_batches(
        self,
        batches: Iterable[io_lib.Batch],
        sink: Callable[[np.ndarray, io_lib.Batch], None] | None = None,
        *,
        _skip_applied: bool = False,
    ) -> dict:
        """Drive the pipeline from pre-assembled :class:`io.Batch` objects
        (e.g. :func:`utils.io.fastq_batches`, the no-per-record-object fast
        parser — ~2x the Record path's host throughput).

        Same delivery semantics as :meth:`run`; when a manifest is
        configured and the caller has not already applied its skip count,
        resume skipping happens here.
        """
        cfg = self.config
        if self.manifest and not _skip_applied:
            skip = self.manifest.batches_done(self.host_id)
            batches = (b for i, b in enumerate(batches) if i >= skip)
        self.logger.start()
        stages = _new_stages()

        def finish(pending):
            """Read back, validate, sink, account — then (and only then)
            advance the manifest, preserving the at-least-once contract."""
            words, batch, bad = pending
            t0 = time.perf_counter()
            words_np = np.asarray(words)
            bad_flag = bool(bad is not None and int(bad))
            stages["readback_s"] += time.perf_counter() - t0
            if bad_flag:
                # invalid input byte somewhere in the batch: diagnose
                # host-side (the rare path) and raise BEFORE sinking
                from ..ops import native

                allow_n = cfg.codec == "base5"
                for row in range(batch.count):
                    seq = bytes(batch.reads[row, : int(batch.lengths[row])])
                    pos = native.find_invalid(seq, allow_n=allow_n)
                    if pos >= 0:
                        raise ValueError(
                            f"invalid byte {seq[pos:pos + 1]!r} at position "
                            f"{pos} of record index {int(batch.indices[row])}"
                        )
                raise ValueError(
                    "device validity check flagged the batch but the host "
                    "scan found no invalid byte (kernel/oracle drift)"
                )
            if sink is not None:
                t0 = time.perf_counter()
                sink(words_np, batch)
                stages["sink_s"] += time.perf_counter() - t0
            self.logger.batch_done(
                nt=int(batch.lengths.sum()), reads=batch.count
            )
            if self.manifest:
                t0 = time.perf_counter()
                self.manifest.advance(self.host_id, 1, batch.count)
                self.manifest.save()
                stages["manifest_s"] += time.perf_counter() - t0

        def dispatch(batch):
            x = self.sharded.shard(batch.reads)
            if cfg.validate:
                words, bad = self.sharded.encode_checked(x, gather=cfg.gather)
            else:
                words, bad = self.sharded.encode(x, gather=cfg.gather), None
            return (words, batch, bad)

        # four-stage software pipeline: the prefetch thread preps batches
        # ahead, the main thread uploads + dispatches (async), and the
        # readback worker blocks on D2H/sink — so host prep, H2D, kernel,
        # D2H and sink I/O all overlap (per-stage seconds in ``stages``)
        t_run = time.perf_counter()
        _pipelined(
            _prefetch(batches, depth=cfg.prefetch_depth, stages=stages),
            dispatch,
            finish,
            readback_depth=cfg.readback_depth,
            stages=stages,
        )
        stages["wall_s"] = time.perf_counter() - t_run
        agg = self.logger.aggregate()
        agg["host_id"] = self.host_id
        agg["num_hosts"] = self.num_hosts
        agg["stages"] = {k: round(v, 4) for k, v in stages.items()}
        return agg


class StreamingDecoder:
    """Cluster-wide streaming decode pipeline: packed entries -> ASCII reads.

    The mirror of :class:`StreamingEncoder` for the read-back direction:
    consumes an iterable of ``(name, length, words)`` entries (the `.nup`
    container's record format — u64 packed words plus the explicit
    nucleotide count the reference's decoders require,
    reference src/n_to_bits.rs:51), batches them into fixed device shapes
    (word width bucketed to a power of two so the number of compiled
    programs stays logarithmic), decodes data-parallel over the host-local
    mesh, and hands each record's exact-length bytes to ``sink``.

    Delivery is at-least-once with a manifest, exactly as for the encoder
    (sinks must be idempotent per record name).
    """

    def __init__(self, config: StreamConfig | None = None, **overrides):
        if config is None:
            config = StreamConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        if config.verify and config.codec != "base5":
            raise ValueError(
                "verify=True is base-5 only: every 2-bit pattern decodes, "
                "there is no invalid state to detect"
            )
        self.host_id = jax.process_index()
        self.num_hosts = jax.process_count()
        self.mesh = mesh_lib.make_mesh(devices=jax.local_devices())
        # the decoder's variant knob selects a DECODE kernel (r05 review:
        # it previously landed in ShardedCodec's encode-variant slot,
        # where a decode-variant name could never apply)
        self.sharded = data_parallel.ShardedCodec(
            config.codec,
            mesh=self.mesh,
            decode_variant=config.variant,
            tier=config.tier,
        )
        self.per_word = 32 if config.codec == "2bit" else 27
        self.logger = metrics_lib.ThroughputLogger(
            name=f"stream-decode-h{self.host_id}", log_every=config.log_every
        )
        self.manifest = (
            ckpt_lib.Manifest(config.manifest_path)
            if config.manifest_path
            else None
        )

    def run(
        self,
        entries: Iterable[tuple[bytes, int, np.ndarray]],
        sink: Callable[[bytes, bytes], None],
    ) -> dict:
        """Decode this host's shard of ``entries``; ``sink(name, seq)`` gets
        each record's exact-length ASCII bytes.  Returns aggregate metrics."""
        from ..ops import spec

        cfg = self.config
        skip = self.manifest.batches_done(self.host_id) if self.manifest else 0
        mine = (
            e for i, e in enumerate(entries) if i % self.num_hosts == self.host_id
        )
        self.logger.start()

        def chunks():
            chunk: list[tuple[bytes, int, np.ndarray]] = []
            for entry in mine:
                chunk.append(entry)
                if len(chunk) == cfg.batch_size:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

        def prepped():
            for i, chunk in enumerate(chunks()):
                if i < skip:
                    continue
                yield chunk, io_lib.pack_words_batch(chunk, cfg.batch_size)

        stages = _new_stages()

        def finish(pending):
            """Read back, verify, sink, account — then (and only then)
            advance the manifest, preserving the at-least-once contract."""
            chunk, dec, bad = pending
            t0 = time.perf_counter()
            dec_np = np.asarray(dec)
            bad_flag = bool(bad is not None and int(bad))
            stages["readback_s"] += time.perf_counter() - t0
            if bad_flag:
                # corrupt stream: diagnose host-side (the rare path) and
                # raise BEFORE anything is sunk or the manifest advances
                from ..ops import seqops

                for name, _, words in chunk:
                    v = spec.u64_to_u32_pairs(
                        np.ascontiguousarray(words)
                    ).reshape(-1)
                    w = int(seqops.first_invalid_word_b5(jnp.asarray(v)))
                    if w >= 0:
                        raise ValueError(
                            f"corrupt base-5 word {w} in record "
                            f"{name.decode(errors='replace')!s}"
                        )
                raise ValueError(
                    "device integrity check flagged the batch but the host "
                    "scan found no corrupt word (check/scan divergence)"
                )
            t0 = time.perf_counter()
            for i, (name, length, _) in enumerate(chunk):
                sink(name, bytes(dec_np[i, :length]))
            stages["sink_s"] += time.perf_counter() - t0
            self.logger.batch_done(
                nt=sum(e[1] for e in chunk), reads=len(chunk)
            )
            if self.manifest:
                t0 = time.perf_counter()
                self.manifest.advance(self.host_id, 1, len(chunk))
                self.manifest.save()
                stages["manifest_s"] += time.perf_counter() - t0

        def dispatch(item):
            chunk, w32 = item
            x = jax.device_put(w32, self.sharded.batch_sharding)
            if cfg.verify:
                dec, bad = self.sharded.decode_checked(x)
            else:
                dec, bad = self.sharded.decode(x), None
            return (chunk, dec, bad)

        # four-stage software pipeline, mirroring the encoder: prefetch
        # packs words ahead, the main thread uploads + dispatches, the
        # readback worker blocks on D2H and sinks
        t_run = time.perf_counter()
        _pipelined(
            _prefetch(prepped(), depth=cfg.prefetch_depth, stages=stages),
            dispatch,
            finish,
            readback_depth=cfg.readback_depth,
            stages=stages,
        )
        stages["wall_s"] = time.perf_counter() - t_run
        agg = self.logger.aggregate()
        agg["host_id"] = self.host_id
        agg["num_hosts"] = self.num_hosts
        agg["stages"] = {k: round(v, 4) for k, v in stages.items()}
        return agg
