"""Host-side streaming input: FASTA/FASTQ readers and batch assembly.

The reference operates on in-memory byte slices only; a production device codec
needs a host streaming layer that feeds resident device batches.  This module
supplies:

* record parsers for FASTA and FASTQ (plain or gzip),
* :class:`BatchStream` — fixed-shape padded u8 batches for the device codecs
  (static shapes keep every batch on the same compiled executable),
* host sharding for multi-host runs (host ``h`` of ``H`` consumes records
  ``i`` with ``i % H == h``), matching the per-host input streams of the
  distributed runtime (SURVEY.md §5 "Distributed communication backend").
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
from typing import Iterable, Iterator, BinaryIO

import numpy as np

from ..ops import native as _native


@dataclasses.dataclass
class Record:
    name: bytes
    seq: bytes


def _open(path: str | os.PathLike) -> BinaryIO:
    f = open(path, "rb")
    if str(path).endswith(".gz"):
        return gzip.open(f)  # type: ignore[return-value]
    return f


def read_fasta(source) -> Iterator[Record]:
    """Iterate FASTA records from a path or binary file object."""
    f = _open(source) if isinstance(source, (str, os.PathLike)) else source
    name, chunks = None, []
    for raw in f:
        line = raw.strip()
        if not line:
            continue
        if line.startswith(b">"):
            if name is not None:
                yield Record(name, b"".join(chunks))
            name, chunks = line[1:], []
        else:
            chunks.append(line)
    if name is not None:
        yield Record(name, b"".join(chunks))


def read_fastq(source) -> Iterator[Record]:
    """Iterate FASTQ records (4-line) from a path or binary file object.

    Plain (non-gzip) paths take the NumPy chunk parser — newline indexing
    over 64 MiB blocks instead of four Python ``readline`` calls per
    record (~10x; the host parse otherwise caps the streaming pipeline) —
    with line-count framing, so ``@``/``+`` inside quality strings cannot
    desynchronize it.  File objects and gzip fall back to the line reader.
    """
    if isinstance(source, (str, os.PathLike)) and not str(source).endswith(".gz"):
        return _read_fastq_np(source)
    return _read_fastq_lines(
        _open(source) if isinstance(source, (str, os.PathLike)) else source
    )


def _read_fastq_lines(f: BinaryIO) -> Iterator[Record]:
    while True:
        header = f.readline()
        if not header:
            return
        seq = f.readline().strip()
        plus = f.readline()
        qual = f.readline()
        if not header.startswith(b"@") or not plus.startswith(b"+"):
            raise ValueError("malformed FASTQ record")
        del qual
        yield Record(header[1:].strip(), seq)


def _read_fastq_np(
    path: str | os.PathLike, chunk_bytes: int = 1 << 26
) -> Iterator[Record]:
    """Chunked NumPy FASTQ parse (4-line records; see :func:`read_fastq`)."""
    carry = b""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            buf = carry + chunk
            arr = np.frombuffer(buf, np.uint8)
            nl = np.flatnonzero(arr == ord("\n"))
            nrec = nl.size // 4
            if nrec == 0:
                carry = buf
                continue
            end = int(nl[4 * nrec - 1]) + 1
            carry = buf[end:]
            starts = np.concatenate([[0], nl[: 4 * nrec - 1] + 1])
            if not (
                np.all(arr[starts[0::4]] == ord("@"))
                and np.all(arr[starts[2::4]] == ord("+"))
            ):
                raise ValueError("malformed FASTQ record")
            for r in range(nrec):
                yield Record(
                    buf[starts[4 * r] + 1 : nl[4 * r]].strip(),
                    buf[starts[4 * r + 1] : nl[4 * r + 1]].strip(),
                )
    if carry.strip():  # trailing record(s) without a final newline
        yield from _read_fastq_lines(io.BytesIO(carry))


def open_reads(path: str | os.PathLike) -> Iterator[Record]:
    """Dispatch on extension: .fa/.fasta[.gz] or .fq/.fastq[.gz]."""
    s = str(path)
    base = s[:-3] if s.endswith(".gz") else s
    if base.endswith((".fa", ".fasta", ".fna")):
        return read_fasta(path)
    if base.endswith((".fq", ".fastq")):
        return read_fastq(path)
    raise ValueError(f"unrecognized reads format: {path}")


def shard_records(
    records: Iterable[Record], host_id: int, num_hosts: int
) -> Iterator[tuple[int, Record]]:
    """Round-robin host sharding; yields (global_index, record)."""
    for i, rec in enumerate(records):
        if i % num_hosts == host_id:
            yield i, rec


@dataclasses.dataclass
class Batch:
    """One device-ready batch: 'A'-padded bytes + true lengths + global ids."""

    reads: np.ndarray    # u8[B, L]
    lengths: np.ndarray  # i32[B]
    indices: np.ndarray  # i64[B] global record indices (-1 for pad rows)
    count: int           # number of real rows


class BatchStream:
    """Assemble records into fixed-shape padded batches.

    Fixed ``(batch_size, max_len)`` keeps device shapes static, so every batch
    reuses one compiled executable (XLA recompiles per shape).  Reads longer
    than ``max_len`` raise unless ``truncate=True``.  The final partial batch
    is padded with empty rows (``indices == -1``).
    """

    def __init__(
        self,
        records: Iterable[Record] | Iterable[tuple[int, Record]],
        batch_size: int,
        max_len: int,
        *,
        block: int = 32,
        truncate: bool = False,
        skip: int = 0,
    ):
        self.batch_size = batch_size
        self.max_len = -(-max_len // block) * block
        self.truncate = truncate
        self.skip = skip  # batches to skip (checkpoint resume)
        self._records = records

    def __iter__(self) -> Iterator[Batch]:
        B, L = self.batch_size, self.max_len
        seqs: list[bytes] = []
        idxs: list[int] = []
        emitted = 0

        def assemble() -> Batch:
            # vectorized row fill (r05): one C-level join + one
            # memcpy/memset pass (ops.native.fill_rows) per batch instead
            # of two NumPy slice assignments per record — the same
            # assembly the fastq_batches fast path uses, so the Record
            # path no longer caps the streaming pipeline on host prep
            nonlocal emitted
            n = len(seqs)
            lens = np.fromiter((len(s) for s in seqs), np.int64, n)
            buf = np.frombuffer(b"".join(seqs), np.uint8)
            starts = np.zeros(n, np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            reads = np.empty((B, L), np.uint8)
            _native.fill_rows(buf, starts, lens, reads)
            lengths = np.zeros(B, np.int32)
            lengths[:n] = np.minimum(lens, L)
            indices = np.full(B, -1, np.int64)
            indices[:n] = idxs
            emitted += 1
            return Batch(reads, lengths, indices, n)

        for item in self._records:
            idx, rec = item if isinstance(item, tuple) else (-1, item)
            # validate per record (not at batch assembly) so the error
            # fires before further records are consumed from the caller's
            # iterator, and skipped batches (manifest resume) still check
            if len(rec.seq) > L and not self.truncate:
                raise ValueError(
                    f"read of length {len(rec.seq)} exceeds max_len {L}"
                )
            seqs.append(rec.seq)
            idxs.append(idx)
            if len(seqs) == B:
                if emitted >= self.skip:
                    yield assemble()
                else:
                    emitted += 1
                seqs, idxs = [], []
        if seqs and emitted >= self.skip:
            yield assemble()


def fastq_batches(
    path: str | os.PathLike,
    batch_size: int,
    max_len: int,
    *,
    block: int = 32,
    truncate: bool = False,
    skip: int = 0,
    chunk_bytes: int = 1 << 26,
) -> Iterator[Batch]:
    """FASTQ straight into padded device batches — no per-record objects.

    The Record/BatchStream path costs ~2 us of Python per read (object
    construction + per-row copy), which caps the streaming pipeline around
    100 Mnt/s regardless of device speed.  This assembler parses 64 MiB
    chunks with newline indexing and fills each ``(batch_size, max_len)``
    batch with two vectorized gathers (one fancy-index copy + one pad
    mask), so host cost per read is O(max_len) C-speed work.  Yields the
    same :class:`Batch` objects the streaming encoder consumes
    (``skip``/``truncate`` semantics match :class:`BatchStream`).
    """
    max_len = -(-max_len // block) * block
    # pending parsed-but-unbatched reads: (buffer, seq_start, seq_len) with
    # buffers referenced by index so batches can span chunk boundaries
    bufs: list[np.ndarray] = []
    pend_buf: list[np.ndarray] = []
    pend_start: list[np.ndarray] = []
    pend_len: list[np.ndarray] = []
    pending = 0
    next_index = 0
    emitted = 0

    def assemble():
        nonlocal pending, next_index, emitted
        reads = np.empty((batch_size, max_len), np.uint8)
        lengths = np.zeros(batch_size, np.int32)
        indices = np.full(batch_size, -1, np.int64)
        row = 0
        take = min(pending, batch_size)
        while row < take:
            b, s, l = pend_buf[0], pend_start[0], pend_len[0]
            n = min(take - row, s.size)
            s_n, l_n = s[:n], l[:n]
            if l_n.size and l_n.max(initial=0) > max_len:
                if not truncate:
                    raise ValueError(
                        f"read of length {int(l_n.max())} exceeds max_len {max_len}"
                    )
                l_n = np.minimum(l_n, max_len)
            # one memcpy+memset per row in C (ops.native.fill_rows; its NumPy
            # fallback is the same per-row slice loop — plain slicing beats a
            # masked fancy-index gather)
            _native.fill_rows(b, s_n, l_n, reads[row : row + n])
            lengths[row : row + n] = l_n
            indices[row : row + n] = np.arange(next_index, next_index + n)
            next_index += n
            row += n
            if n == s.size:
                pend_buf.pop(0), pend_start.pop(0), pend_len.pop(0)
            else:
                pend_buf[0], pend_start[0], pend_len[0] = b, s[n:], l[n:]
        reads[take:] = ord("A")
        pending -= take
        emitted += 1
        return Batch(reads, lengths, indices, take)

    def discard():
        # manifest-resume skip: advance the pending bookkeeping without
        # the fill_rows copies (r05 review: deep resumes paid a full
        # batch assembly per skipped batch).  Length validation still
        # runs so a skipped overlong read fails the same way.
        nonlocal pending, next_index, emitted
        take = min(pending, batch_size)
        row = 0
        while row < take:
            s, l = pend_start[0], pend_len[0]
            n = min(take - row, s.size)
            if not truncate and l[:n].size and l[:n].max(initial=0) > max_len:
                raise ValueError(
                    f"read of length {int(l[:n].max())} exceeds max_len "
                    f"{max_len}"
                )
            next_index += n
            row += n
            if n == s.size:
                pend_buf.pop(0), pend_start.pop(0), pend_len.pop(0)
            else:
                pend_start[0], pend_len[0] = s[n:], l[n:]
        pending -= take
        emitted += 1

    def push(arr: np.ndarray, starts: np.ndarray, lens: np.ndarray):
        nonlocal pending
        pend_buf.append(arr)
        pend_start.append(starts.astype(np.int64))
        pend_len.append(lens.astype(np.int64))
        pending += starts.size

    def push_ends(buf_bytes: bytes, starts: np.ndarray, ends: np.ndarray):
        arr = np.frombuffer(buf_bytes, np.uint8)
        # strip trailing \r (CRLF input)
        ends = ends - (arr[np.maximum(ends - 1, 0)] == ord("\r"))
        push(arr, starts, ends - starts)

    carry = b""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            buf = carry + chunk
            arr = np.frombuffer(buf, np.uint8)
            scan = _native.fastq_scan(arr)
            if scan is not None:
                # one memchr-driven C pass: spans + framing validation
                starts, lens, consumed = scan
                if starts.size == 0:
                    carry = buf
                    continue
                carry = buf[consumed:]
                push(arr, starts, lens)
            else:
                nl = np.flatnonzero(arr == ord("\n"))
                nrec = nl.size // 4
                if nrec == 0:
                    carry = buf
                    continue
                nl4 = nl[: 4 * nrec]
                carry = buf[int(nl4[-1]) + 1 :]
                starts = np.concatenate([[0], nl4[:-1] + 1])
                if not (
                    np.all(arr[starts[0::4]] == ord("@"))
                    and np.all(arr[starts[2::4]] == ord("+"))
                ):
                    raise ValueError("malformed FASTQ record")
                push_ends(buf, starts[1::4], nl4[1::4])
            while pending >= batch_size:
                if emitted >= skip:
                    yield assemble()
                else:
                    discard()
    if carry.strip():
        tail = list(_read_fastq_lines(io.BytesIO(carry)))
        if tail:
            seqs = b"\n".join(r.seq for r in tail) + b"\n"
            arr = np.frombuffer(seqs, np.uint8)
            ends = np.flatnonzero(arr == ord("\n"))
            starts = np.concatenate([[0], ends[:-1] + 1])
            push_ends(seqs, starts, ends)
    while pending:
        if emitted >= skip:
            yield assemble()
        else:
            discard()


def pack_words_batch(
    chunk: list[tuple[bytes, int, np.ndarray]], batch_size: int
) -> np.ndarray:
    """Pack ``(name, length, u64-words)`` entries into one fixed-shape
    device batch: u32[batch_size, 2 * bucket] (little-endian u32 pairs).

    The word width buckets to the next power of two so the number of
    compiled decode programs stays logarithmic in record length; short
    records zero-pad (tail words decode to 'A' runs that the caller's
    per-record ``length`` truncation drops).  Shared by the CLI decode
    batch path and the streaming decoder — their batching must stay
    bit-identical.
    """
    from ..ops import spec

    wmax = max((e[2].size for e in chunk), default=1)
    bucket = 1 << max(wmax - 1, 0).bit_length()
    mat = np.zeros((batch_size, bucket), dtype="<u8")
    for i, (_, _, words) in enumerate(chunk):
        mat[i, : words.size] = words
    return spec.u64_to_u32_pairs(mat).reshape(batch_size, 2 * bucket)
