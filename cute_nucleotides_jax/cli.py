"""Command-line interface: encode / decode / parity-gate / bench.

The reference ships no CLI (it is a library crate); production deployment
needs one.  Subcommands:

* ``encode``  — FASTA/FASTQ (or raw) -> packed stream file (.nup)
* ``decode``  — packed stream file -> FASTA
* ``parity``  — randomized parity gate: device tiers vs the C++/NumPy oracle
* ``bench``   — delegates to the repo-root criterion-analogue harness

The packed container (".nup") is a minimal self-describing format::

    magic b"NUPK" | version u32 | codec u8 (2=2bit, 5=base5) | reserved[3]
    count u64 | (name_len u32, length u64)*count | names | packed words

Words are the reference's exact little-endian u64 stream per read,
concatenated (each read starts word-aligned).
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys

import numpy as np

MAGIC = b"NUPK"
VERSION = 1

#: mirror of api._TIERS (hardcoded so --help stays jax-import-free; a test
#: asserts the two stay equal) — argparse rejects typos before any output
#: file is opened/truncated
_TIERS = ("oracle", "xla", "auto")


def write_nup(path: str, names: list[bytes], seqs_words: list[np.ndarray],
              lengths: list[int], codec: str) -> None:
    code = 2 if codec == "2bit" else 5
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IB3x", VERSION, code))
        f.write(struct.pack("<Q", len(names)))
        for name, length in zip(names, lengths):
            f.write(struct.pack("<IQ", len(name), length))
        for name in names:
            f.write(name)
        for words in seqs_words:
            f.write(np.ascontiguousarray(words, dtype="<u8").tobytes())


class NupReader:
    """Seekable random access to a .nup container.

    Only the header (magic + per-record name/length table) is read
    eagerly; a record's packed words are fetched with one ``seek`` at
    access time.  Extracting one region from a many-GB container
    therefore touches the header plus that record's words — the
    faidx-style access pattern ``cmd_region`` needs (the eager
    :func:`read_nup` remains for whole-file consumers).  Duplicate
    record names resolve to the first occurrence.
    """

    def __init__(self, path: str):
        from .ops import spec

        self._f = open(path, "rb")
        try:
            if self._f.read(4) != MAGIC:
                raise ValueError("not a .nup file")
            version, code = struct.unpack("<IB3x", self._f.read(8))
            if version != VERSION:
                raise ValueError(f"unsupported version {version}")
            if code == 2:
                self.codec = "2bit"
            elif code == 5:
                self.codec = "base5"
            else:
                raise ValueError(f"unknown codec byte {code} (expected 2 or 5)")
            (count,) = struct.unpack("<Q", self._f.read(8))
            meta = [struct.unpack("<IQ", self._f.read(12)) for _ in range(count)]
            self.names = [self._f.read(nl) for nl, _ in meta]
            self.lengths = [int(length) for _, length in meta]
            per_word = (
                spec.NT_PER_WORD_2BIT if self.codec == "2bit"
                else spec.NT_PER_WORD_B5
            )
            off = self._f.tell()
            self._offsets, self._nwords = [], []
            for length in self.lengths:
                nw = spec.cdiv(length, per_word)
                self._offsets.append(off)
                self._nwords.append(nw)
                off += 8 * nw
            self._by_name: dict[bytes, int] = {}
            for i, name in enumerate(self.names):
                self._by_name.setdefault(name, i)
        except Exception:
            self._f.close()
            raise

    def __len__(self) -> int:
        return len(self.names)

    def __contains__(self, name: bytes) -> bool:
        return name in self._by_name

    def words(self, i: int) -> np.ndarray:
        """Packed u64 words of record ``i`` (one seek + one read)."""
        self._f.seek(self._offsets[i])
        raw = self._f.read(8 * self._nwords[i])
        if len(raw) != 8 * self._nwords[i]:
            # a truncated container must ERROR, not decode fabricated
            # 'A' runs from zero padding (r05 review, reproduced)
            raise ValueError(
                f"truncated container: record {i} "
                f"({self.names[i].decode(errors='replace')!s}) needs "
                f"{8 * self._nwords[i]} bytes, file holds {len(raw)}"
            )
        return np.frombuffer(raw, dtype="<u8")

    def get(self, name: bytes) -> tuple[int, np.ndarray]:
        """``(length, words)`` for the first record named ``name``."""
        i = self._by_name[name]
        return self.lengths[i], self.words(i)

    def __iter__(self):
        for i, (name, length) in enumerate(zip(self.names, self.lengths)):
            yield name, length, self.words(i)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "NupReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_nup(path: str):
    with NupReader(path) as r:
        return r.codec, list(r)


def cmd_encode(args) -> int:
    from . import api
    from .ops import native, spec
    from .utils import io as io_lib

    records = list(io_lib.open_reads(args.input))
    names, words_list, lengths = [], [], []
    total_nt = 0
    if args.validate and not args.batch:
        for rec in records:
            bad = native.find_invalid(rec.seq, allow_n=args.codec == "base5")
            if bad >= 0:
                print(
                    f"error: invalid byte {rec.seq[bad]!r} at {bad} in "
                    f"{rec.name.decode(errors='replace')}",
                    file=sys.stderr,
                )
                return 1

    if args.batch:
        # production path: device batches through the codec models
        if args.tier == "oracle":
            # the codec models are device-tier only (r05 review: 2-bit
            # crashed with KeyError 'lut', base-5 silently ran XLA while
            # labeled oracle); the per-record path IS the oracle tier
            print(
                "error: --tier oracle has no batch device path; drop "
                "--batch (the per-record path runs the host oracle)",
                file=sys.stderr,
            )
            return 2
        import jax.numpy as jnp

        from .models import Base5Codec, TwoBitCodec

        codec_cls = TwoBitCodec if args.codec == "2bit" else Base5Codec
        codec = codec_cls(tier=args.tier)
        words_for = (
            spec.num_words_2bit if args.codec == "2bit" else spec.num_words_b5
        )
        stream = io_lib.BatchStream(
            records, batch_size=args.batch, max_len=args.max_len,
            block=codec.block,
        )
        for b in stream:
            if args.validate:
                # the device check compiles into the encode's program; the
                # host oracle diagnoses only flagged batches (rare path)
                out_dev, bad = codec.encode_checked(jnp.asarray(b.reads))
                out = np.asarray(out_dev)
                if bool(np.any(np.asarray(bad))):
                    for row in range(b.count):
                        seq = bytes(b.reads[row, : int(b.lengths[row])])
                        pos = native.find_invalid(
                            seq, allow_n=args.codec == "base5"
                        )
                        if pos >= 0:
                            rec = records[len(words_list) + row]
                            print(
                                f"error: invalid byte {seq[pos]!r} at {pos} "
                                f"in {rec.name.decode(errors='replace')}",
                                file=sys.stderr,
                            )
                            return 1
                    # the fused device check and the host oracle are proven
                    # to agree (padding is 'A', checker exact on all 256
                    # bytes); if they ever drift, fail loudly instead of
                    # silently writing a batch the device flagged
                    print(
                        "error: device validity check flagged this batch "
                        "but the host scan found no invalid byte "
                        "(kernel/oracle drift — refusing to write)",
                        file=sys.stderr,
                    )
                    return 1
            else:
                out = np.asarray(codec.encode(jnp.asarray(b.reads)))
            for row in range(b.count):
                n = int(b.lengths[row])
                rec_words = spec.u32_pairs_to_u64(out[row])[: words_for(n)]
                words_list.append(rec_words)
                lengths.append(n)
        names = [r.name for r in records]
    else:
        fn = api.n_to_bits if args.codec == "2bit" else api.n_to_bits2
        for rec in records:
            words_list.append(fn(rec.seq, tier=args.tier))
            names.append(rec.name)
            lengths.append(len(rec.seq))
    total_nt = sum(lengths)
    write_nup(args.output, names, words_list, lengths, args.codec)
    print(
        json.dumps(
            {"records": len(names), "nt": total_nt, "codec": args.codec,
             "output": args.output}
        )
    )
    return 0


def _write_fasta(out, name: bytes, data: bytes) -> None:
    out.write(b">" + name + b"\n")
    for i in range(0, len(data), 80):
        out.write(data[i : i + 80] + b"\n")


def cmd_decode(args) -> int:
    from . import api
    from .ops import spec

    codec, entries = read_nup(args.input)
    verify = getattr(args, "verify_stream", False) and codec == "base5"
    if verify and not args.batch:
        # cheap whole-stream integrity scan before decode: base-5 words
        # waste 3 of 128 triplet codes + the pad bit, so corruption is
        # detectable (the 2-bit stream has no invalid states).  The batch
        # path skips this second pass — its check is FUSED into the decode
        # kernel (see below).
        import jax.numpy as jnp

        from .ops import seqops

        for name, _, words in entries:
            w32 = spec.u64_to_u32_pairs(
                np.ascontiguousarray(words)
            ).reshape(-1)
            bad = int(seqops.first_invalid_word_b5(jnp.asarray(w32)))
            if bad >= 0:
                print(
                    f"error: corrupt base-5 word {bad} in record "
                    f"{name.decode(errors='replace')}",
                    file=sys.stderr,
                )
                return 1
    if args.batch and args.tier == "oracle":
        # the codec models are device-tier only (r05 review: 2-bit
        # crashed with KeyError 'lut', base-5 silently ran XLA while
        # labeled oracle); the per-record path IS the oracle tier
        print(
            "error: --tier oracle has no batch device path; drop "
            "--batch (the per-record path runs the host oracle)",
            file=sys.stderr,
        )
        return 2
    # file output is written to a temp path and renamed only on success, so
    # a corruption abort (or any mid-run failure) can neither leave a
    # truncated FASTA behind nor clobber a pre-existing file (stdout output
    # streams as written — consumers must honor the exit code there)
    to_file = args.output != "-"
    tmp_path = args.output + ".tmp" if to_file else None
    out = open(tmp_path, "wb") if to_file else sys.stdout.buffer
    rc = 0
    try:
        if args.batch:
            # production path, symmetric to `encode --batch`: fixed-shape
            # device batches (row count and word width bucketed so compile
            # count stays bounded), per-record truncation host-side
            import jax.numpy as jnp

            from .models import Base5Codec, TwoBitCodec

            from .utils import io as io_lib

            codec_cls = TwoBitCodec if codec == "2bit" else Base5Codec
            cd = codec_cls(tier=args.tier)
            for start in range(0, len(entries), args.batch):
                chunk = entries[start : start + args.batch]
                w32 = io_lib.pack_words_batch(chunk, args.batch)
                if verify:
                    # integrity check compiled into the decode's program
                    # (device flag per batch; the host scan diagnoses the
                    # record + word index only on flagged batches)
                    dec_d, bad = cd.decode_checked(jnp.asarray(w32))
                    dec = np.asarray(dec_d)
                    if bool(bad):
                        from .ops import seqops

                        diagnosed = False
                        for name, _, words in chunk:
                            v = spec.u64_to_u32_pairs(
                                np.ascontiguousarray(words)
                            ).reshape(-1)
                            w = int(seqops.first_invalid_word_b5(jnp.asarray(v)))
                            if w >= 0:
                                print(
                                    f"error: corrupt base-5 word {w} in "
                                    f"record {name.decode(errors='replace')}",
                                    file=sys.stderr,
                                )
                                diagnosed = True
                        if not diagnosed:
                            # device flag without a host diagnosis would mean
                            # the fused check drifted from the scan — fail
                            # loudly rather than silently decode corruption
                            print(
                                "error: device integrity check flagged the "
                                "batch but the host scan found no corrupt "
                                "word (check/scan divergence)",
                                file=sys.stderr,
                            )
                        rc = 1
                        return rc
                else:
                    dec = np.asarray(cd.decode(jnp.asarray(w32)))
                for i, (name, length, _) in enumerate(chunk):
                    _write_fasta(out, name, bytes(dec[i, :length]))
        else:
            fn = api.bits_to_n if codec == "2bit" else api.bits_to_n2
            for name, length, words in entries:
                seq = fn(words, length, tier=args.tier)
                _write_fasta(out, name, bytes(seq))
    except BaseException:
        rc = 1
        raise
    finally:
        if to_file:
            out.close()
            if rc == 0:
                os.replace(tmp_path, args.output)
            else:
                os.unlink(tmp_path)
    return 0


def cmd_parity(args) -> int:
    """Randomized parity gate: every tier must match the oracle bit-exactly."""
    from . import api
    from .ops import native, oracle

    rng = np.random.default_rng(args.seed)
    alpha = np.frombuffer(b"ACGTUacgtu", np.uint8)
    alpha_n = np.frombuffer(b"ACGTUNacgtun", np.uint8)
    tiers = args.tiers.split(",")
    failures = 0
    for trial in range(args.trials):
        n = int(rng.integers(1, args.max_len + 1))
        kind = trial % 3
        s = rng.choice(alpha_n if kind == 1 else alpha, size=n)
        if kind == 2:
            s = rng.integers(0, 256, size=n, dtype=np.int64).astype(np.uint8)
        w_ref = oracle.n_to_bits_lut(s)
        w5_ref = oracle.n_to_bits2_lut(s)
        checks = [("native", native.n_to_bits(s), w_ref),
                  ("native-b5", native.n_to_bits2(s), w5_ref)]
        for tier in tiers:
            checks.append((f"{tier}", api.n_to_bits(s, tier=tier), w_ref))
            checks.append((f"{tier}-b5", api.n_to_bits2(s, tier=tier), w5_ref))
        for label, got, want in checks:
            if not np.array_equal(got, want):
                print(f"PARITY FAIL [{label}] n={n} trial={trial}", file=sys.stderr)
                failures += 1
        # decode roundtrip
        for tier in tiers:
            back = api.bits_to_n(w_ref, n, tier=tier)
            if not np.array_equal(back, oracle.bits_to_n_lut(w_ref, n)):
                print(f"PARITY FAIL [decode-{tier}] n={n}", file=sys.stderr)
                failures += 1
            back5 = api.bits_to_n2(w5_ref, n, tier=tier)
            if not np.array_equal(back5, oracle.bits_to_n2_lut(w5_ref, n)):
                print(f"PARITY FAIL [decode-{tier}-b5] n={n}", file=sys.stderr)
                failures += 1
    status = "PASS" if failures == 0 else "FAIL"
    print(json.dumps({"parity": status, "trials": args.trials, "failures": failures}))
    return 0 if failures == 0 else 1


def cmd_stats(args) -> int:
    """Packed-domain analytics over reads: GC content + top k-mers.

    Demonstrates the point of the codec: everything below runs on the packed
    stream, never decoding back to ASCII.
    """
    import jax.numpy as jnp

    from . import api
    from .ops import kmer, seqops, spec
    from .utils import io as io_lib

    if args.input.endswith(".nup"):
        codec, entries = read_nup(args.input)
        if codec != "2bit":
            print("stats requires a 2-bit stream", file=sys.stderr)
            return 1
        seqs = [(length, words) for _, length, words in entries]
    else:
        seqs = []
        for rec in io_lib.open_reads(args.input):
            seqs.append((len(rec.seq), api.n_to_bits(rec.seq, tier=args.tier)))

    total_nt = sum(n for n, _ in seqs)
    gc = 0
    comp = np.zeros(4, np.int64)
    hist = None
    counts_map: dict[int, int] = {}
    use_counts = args.k > 12  # past the dense-histogram ceiling (17 TB at 21)
    for n, words in seqs:
        w32 = jnp.asarray(spec.u64_to_u32_pairs(
            np.ascontiguousarray(words)).reshape(-1))
        gc += int(seqops.gc_content_packed(w32))
        comp += np.asarray(seqops.base_composition_packed(w32, n), np.int64)
        if n >= args.k:
            if use_counts:
                lo, hi, cnt = map(
                    np.asarray,
                    kmer.kmer_counts(w32, n, args.k, canonical=args.canonical),
                )
                for i in np.nonzero(cnt)[0]:
                    code = (int(hi[i]) << 32) | int(lo[i])
                    counts_map[code] = counts_map.get(code, 0) + int(cnt[i])
            else:
                h = kmer.kmer_histogram(w32, n, args.k, canonical=args.canonical)
                hist = h if hist is None else hist + h
    out = {
        "records": len(seqs),
        "nt": total_nt,
        "gc_fraction": round(gc / max(total_nt, 1), 6),
        "composition": dict(zip("ACTG", (int(c) for c in comp))),
        "k": args.k,
        "canonical": bool(args.canonical),
    }
    chars = np.frombuffer(b"ACTG", np.uint8)

    def code_to_str(c):
        return "".join(chr(chars[(c >> (2 * j)) & 3]) for j in range(args.k))

    if use_counts and counts_map:
        out["distinct_kmers"] = len(counts_map)
        top = sorted(counts_map.items(), key=lambda kv: -kv[1])[: args.top]
        out["top_kmers"] = [
            {"kmer": code_to_str(c), "count": n} for c, n in top
        ]
    elif hist is not None:
        hist_np = np.asarray(hist)
        top = np.argsort(hist_np)[::-1][: args.top]
        out["top_kmers"] = [
            {"kmer": code_to_str(int(c)), "count": int(hist_np[c])}
            for c in top if hist_np[c] > 0
        ]
    print(json.dumps(out))
    return 0


def _parse_region(spec_str: str) -> tuple[bytes, int, int]:
    """``NAME:START-END`` (0-based half-open) -> (name, start, end)."""
    name, _, span = spec_str.rpartition(":")
    if not name or "-" not in span:
        raise ValueError(f"region must be NAME:START-END, got {spec_str!r}")
    s, _, e = span.partition("-")
    start, end = int(s), int(e)
    if start < 0 or end < start:
        raise ValueError(f"bad region bounds in {spec_str!r}")
    return name.encode(), start, end


def cmd_region(args) -> int:
    """Extract subsequences from a .nup container on the packed domain.

    The samtools-faidx analogue: the window is cut with
    :func:`ops.seqops.packed_slice` / ``packed_slice_b5`` — a funnel pass
    over the packed words, no whole-record decode — then either decoded
    (FASTA out) or written still-packed to a new .nup (``--packed``).
    """
    import jax.numpy as jnp

    from . import api
    from .ops import seqops, spec

    reader = NupReader(args.input)
    codec = reader.codec
    packed_out: list[tuple[bytes, int, np.ndarray]] = []
    # temp + rename-on-success: a failed region lookup must not truncate
    # a pre-existing output file (r05 review; the cmd_decode convention)
    to_file = args.output != "-"
    tmp_path = args.output + ".tmp" if to_file else None
    out = open(tmp_path, "wb") if to_file else sys.stdout.buffer
    ok = False
    try:
        for reg in args.regions:
            name, start, end = _parse_region(reg)
            if name not in reader:
                print(
                    f"error: no record {name.decode(errors='replace')!r} "
                    f"in {args.input}",
                    file=sys.stderr,
                )
                return 1
            # seek-based: reads only this record's words, not the container
            if reader.names.count(name) > 1:
                print(
                    f"warning: {len([n for n in reader.names if n == name])} "
                    f"records named {name.decode(errors='replace')!r}; "
                    "using the first",
                    file=sys.stderr,
                )
            length, words = reader.get(name)
            if end > length:
                print(
                    f"error: region {reg} overruns record length {length}",
                    file=sys.stderr,
                )
                return 1
            n = end - start
            w32 = jnp.asarray(
                spec.u64_to_u32_pairs(np.ascontiguousarray(words)).reshape(-1)
            )
            op = seqops.packed_slice if codec == "2bit" else seqops.packed_slice_b5
            sl = np.asarray(op(w32, start, n))
            w64 = spec.u32_pairs_to_u64(sl.reshape(-1, 2))
            tag = name + f":{start}-{end}".encode()
            if args.packed:
                packed_out.append((tag, n, w64))
            else:
                fn = api.bits_to_n if codec == "2bit" else api.bits_to_n2
                _write_fasta(out, tag, bytes(fn(w64, n, tier=args.tier)))
        if args.packed:
            if args.output == "-":
                print("error: --packed needs an output path", file=sys.stderr)
                return 1
            out.close()
            write_nup(
                args.output,
                [t for t, _, _ in packed_out],
                [w for _, _, w in packed_out],
                [n for _, n, _ in packed_out],
                codec,
            )
        ok = True
    finally:
        reader.close()
        if to_file:
            if not out.closed:
                out.close()
            if ok and not args.packed:
                os.replace(tmp_path, args.output)
            elif os.path.exists(tmp_path):
                os.unlink(tmp_path)
    return 0


def _grep_batched(args, entries, queries, is_b5: bool) -> int:
    """Batched grep: fixed-shape device batches (word width bucketed by
    ``pack_words_batch``, the decode-path convention), ONE device call per
    batch and strand instead of one per record — the production path when
    a .nup holds many records (each record would otherwise pay its own
    host-device round trip)."""
    import jax.numpy as jnp

    from .ops import search
    from .utils import io as io_lib

    mask_fn = search.match_mask_b5_batch if is_b5 else search.match_mask_batch
    total = 0
    for start in range(0, len(entries), args.batch):
        chunk = entries[start : start + args.batch]
        w32 = io_lib.pack_words_batch(chunk, args.batch)
        lengths = np.zeros(args.batch, np.int32)
        for i, (_, length, _) in enumerate(chunk):
            lengths[i] = length
        per_strand = {}
        for q, strand in queries:
            cap = (
                (w32.shape[1] // 2) * 27 if is_b5 else w32.shape[1] * 16
            )
            if cap - len(q) + 1 <= 0:  # every record shorter than the query
                per_strand[strand] = np.zeros(
                    (args.batch, 0), dtype=bool
                )
                continue
            per_strand[strand] = np.asarray(
                mask_fn(jnp.asarray(w32), jnp.asarray(lengths), q)
            )
        for i, (name, length, _) in enumerate(chunk):
            rec = name.decode(errors="replace")
            if args.count:
                print(
                    json.dumps(
                        {"record": rec, **{
                            ("fwd" if s == "+" else "rev"): int(m[i].sum())
                            for s, m in per_strand.items()
                        }}
                    )
                )
                total += sum(int(m[i].sum()) for m in per_strand.values())
            else:
                hits = sorted(
                    (int(p), s)
                    for s, m in per_strand.items()
                    for p in np.flatnonzero(m[i])
                )
                total += len(hits)
                # stream per record (batches run in record order): a
                # buffered list grew unboundedly on hit-dense containers
                # and starved pipe consumers until scan end (r05 review)
                for p, strand in hits:
                    print(
                        json.dumps(
                            {"record": rec, "pos": p, "strand": strand}
                        )
                    )
    return 0 if total or args.count else 1


def _parse_frames(spec_str: str) -> list[int]:
    """'all' or a comma list from {1,2,3,-1,-2,-3} (EMBOSS numbering)."""
    if spec_str == "all":
        return [1, 2, 3, -1, -2, -3]
    out = []
    for tok in spec_str.split(","):
        f = int(tok)
        if f not in (1, 2, 3, -1, -2, -3):
            raise ValueError(f"frame {tok} not in 1,2,3,-1,-2,-3")
        out.append(f)
    return out


def cmd_translate(args) -> int:
    """Translate .nup records to protein FASTA on the packed domain.

    Codons are read straight off the packed words — 2-bit streams via the
    k=3 funnel (:func:`ops.seqops.translate_packed`), base-5 streams via
    the triplet-is-the-codon LUT (``translate_packed_b5``, N-codons → X);
    minus-strand frames reverse-complement on the packed domain first.
    One compile per distinct (length, frame) — fine for the CLI's
    record-at-a-time usage.
    """
    import jax.numpy as jnp

    from .ops import seqops, spec

    try:
        frames = _parse_frames(args.frames)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    codec, entries = read_nup(args.input)
    fwd = (
        seqops.translate_packed if codec == "2bit"
        else seqops.translate_packed_b5
    )
    rcfn = (
        seqops.revcomp_packed if codec == "2bit"
        else seqops.revcomp_packed_b5
    )
    # temp + rename-on-success (the cmd_decode convention): a mid-run
    # failure must not leave a truncated or clobbered output (r05 review)
    to_file = args.output != "-"
    tmp_path = args.output + ".tmp" if to_file else None
    out = open(tmp_path, "wb") if to_file else sys.stdout.buffer
    ok = False
    try:
        for name, length, words in entries:
            w32 = jnp.asarray(
                spec.u64_to_u32_pairs(np.ascontiguousarray(words)).reshape(-1)
            )
            rc = None
            for f in frames:
                off = abs(f) - 1
                if (length - off) // 3 <= 0:
                    continue  # no whole codon in this frame
                if f > 0:
                    src = w32
                else:
                    if rc is None:
                        rc = rcfn(w32, length)
                    src = rc
                aa = bytes(np.asarray(fwd(src, length, off)))
                _write_fasta(out, name + b"|frame=%+d" % f, aa)
        ok = True
    finally:
        if to_file:
            if not out.closed:
                out.close()
            if ok:
                os.replace(tmp_path, args.output)
            elif os.path.exists(tmp_path):
                os.unlink(tmp_path)
    return 0


def _dataset_sketch(path: str, args):
    """One dataset-level sketch of every read in ``path`` (FASTA/FASTQ or a
    2-bit .nup): -> (sorted u32[s] sketch, records, total_nt).

    Reads sketch in fixed-shape device batches (one compile per distinct
    batch geometry); batch sketches union-merge via :func:`ops.sketch.merge`
    — associativity is what makes the streaming accumulation exact.
    """
    import jax.numpy as jnp

    from .ops import sketch as sketch_lib
    from .ops import spec
    from .utils import io as io_lib

    def sketch_batch(words, lengths, invalid=None):
        if args.scale:
            sk, _ = sketch_lib.frac_sketch_batch(
                words, lengths, args.k,
                scale=args.scale, cap=args.s,
                canonical=not args.no_canonical, invalid=invalid,
            )
            return sk
        return sketch_lib.bottom_k_sketch_batch(
            words, lengths, args.k, args.s,
            canonical=not args.no_canonical, invalid=invalid,
        )

    acc = None
    records = 0
    total_nt = 0
    if path.endswith(".nup"):
        codec, entries = read_nup(path)
        if codec != "2bit":
            raise ValueError(f"{path}: sketch requires a 2-bit stream")
        rows = [
            (length, spec.u64_to_u32_pairs(
                np.ascontiguousarray(words)).reshape(-1))
            for _, length, words in entries
        ]
        for i in range(0, len(rows), args.batch):
            chunk = rows[i : i + args.batch]
            # rows sized to the chunk (W already varies per chunk, so a
            # fixed row count would buy no compile reuse — only padding)
            W = max(w.shape[0] for _, w in chunk)
            words = np.zeros((len(chunk), W), np.uint32)
            lengths = np.zeros(len(chunk), np.int32)
            for j, (n, w) in enumerate(chunk):
                words[j, : w.shape[0]] = w
                lengths[j] = n
                records += 1
                total_nt += n
            sk = sketch_batch(jnp.asarray(words), jnp.asarray(lengths))
            acc = sk if acc is None else sketch_lib.merge(acc, sk)
    else:
        recs = list(io_lib.open_reads(path))
        if recs:
            from .models import TwoBitCodec
            from .ops import validate

            codec = TwoBitCodec(tier=args.tier)
            max_len = max(len(r.seq) for r in recs)
            stream = io_lib.BatchStream(
                recs, batch_size=args.batch, max_len=max_len,
                block=codec.block,
            )
            for b in stream:
                reads = jnp.asarray(b.reads)
                words = codec.encode(reads)
                # Mash/sourmash rule: k-mers touching N (or any byte the
                # 2-bit code cannot represent) are dropped, not mis-hashed
                sk = sketch_batch(
                    words, jnp.asarray(b.lengths),
                    invalid=~validate.valid_mask(reads),
                )
                acc = sk if acc is None else sketch_lib.merge(acc, sk)
                records += b.count
                total_nt += int(b.lengths.sum())
    if acc is None:
        acc = jnp.full(args.s, sketch_lib.SENTINEL, jnp.uint32)
    return acc, records, total_nt


def cmd_sketch(args) -> int:
    """MinHash-sketch datasets and estimate pairwise similarity (Mash-style).

    Each input (FASTA/FASTQ/.nup) reduces to one tiny sorted-hash summary
    built straight from packed words (:mod:`ops.sketch`); with two or more
    inputs, prints the pairwise Jaccard / containment / Mash-distance table
    computed from the summaries alone — the datasets are never compared
    directly.
    """
    from .ops import sketch as sketch_lib

    if args.k > 31:
        print("error: k must be <= 31", file=sys.stderr)
        return 2
    datasets = []
    for path in args.inputs:
        try:
            sk, records, nt = _dataset_sketch(path, args)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        datasets.append((path, sk, records, nt))
    out = {
        "k": args.k,
        "scheme": (
            {"name": "fracminhash", "scale": args.scale, "cap": args.s}
            if args.scale else {"name": "bottom-s", "s": args.s}
        ),
        "canonical": not args.no_canonical,
    }
    ds_rows = []
    for path, sk, records, nt in datasets:
        row = {
            "path": path,
            "records": records,
            "nt": nt,
            "hashes": int((np.asarray(sk) != sketch_lib.SENTINEL).sum()),
        }
        if args.scale:
            # a full buffer means the retained sample was TRUNCATED and
            # the scheme's unbiased-containment property no longer holds
            row["saturated"] = row["hashes"] >= args.s
            if row["saturated"]:
                print(
                    f"warning: {path}: FracMinHash buffer saturated at "
                    f"{args.s} hashes — containment/Jaccard will be "
                    f"underestimated; raise -s or --scale",
                    file=sys.stderr,
                )
        ds_rows.append(row)
    out["datasets"] = ds_rows
    pairs = []
    for i in range(len(datasets)):
        for j in range(i + 1, len(datasets)):
            pa, sa, _, _ = datasets[i]
            pb, sb, _, _ = datasets[j]
            jac = float(sketch_lib.jaccard(sa, sb))
            pairs.append({
                "a": pa,
                "b": pb,
                "jaccard": round(jac, 6),
                "mash_distance": round(
                    sketch_lib.mash_distance(jac, args.k), 6
                ),
                "containment_a_in_b": round(
                    float(sketch_lib.containment(sa, sb)), 6
                ),
                "containment_b_in_a": round(
                    float(sketch_lib.containment(sb, sa)), 6
                ),
            })
    if pairs:
        out["pairs"] = pairs
    print(json.dumps(out))
    return 0


def _revcomp_pattern(raw: bytes, is_b5: bool) -> bytes:
    """Reverse-complement a CLI pattern, preserving wildcard semantics.

    Base-5 patterns use ``?`` as the wildcard, which is not a base:
    complement via the N placeholder, then restore each ``?`` at its
    reversed position (literal Ns keep mapping N -> N)."""
    from .ops import search

    if is_b5:
        rc = search.revcomp_query(raw.replace(b"?", b"N"))
        return bytes(
            ord("?") if p == ord("?") else w
            for p, w in zip(raw[::-1], rc)
        )
    return search.revcomp_query(raw)


def cmd_grep(args) -> int:
    """Find every occurrence of a pattern in a .nup's records, scanning the
    PACKED words (``ops.search`` — no decode pass).  On 2-bit streams ``N``
    in the pattern is a wildcard; on base-5 streams ``N`` is a literal (the
    codec has a real N digit) and ``?`` is the wildcard.  Prints one JSON
    line per hit: record, 0-based position, strand; ``--count`` prints one
    line per record with totals instead."""
    import jax.numpy as jnp

    from .ops import search, spec

    codec, entries = read_nup(args.input)
    is_b5 = codec != "2bit"
    compile_q = search.compile_query_b5 if is_b5 else search.compile_query
    positions = search.match_positions_b5 if is_b5 else search.match_positions
    try:
        compile_q(args.pattern.encode())
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    queries = [(args.pattern.encode(), "+")]
    if args.both:
        raw = args.pattern.encode()
        rc = _revcomp_pattern(raw, is_b5)
        if rc != raw.upper().replace(b"U", b"T"):
            queries.append((rc, "-"))
    if args.batch:
        return _grep_batched(args, entries, queries, is_b5)
    total = 0
    for name, length, words in entries:
        counts = {}
        hits = []
        # one conversion + transfer per record, shared by both strands
        # (rebuilding inside the strand loop doubled the host-device
        # round trips with --both)
        w32 = jnp.asarray(
            spec.u64_to_u32_pairs(np.ascontiguousarray(words)).reshape(-1)
        )
        for q, strand in queries:
            if length < len(q):
                counts[strand] = 0
                continue
            pos = positions(w32, length, q)
            counts[strand] = len(pos)
            hits.extend((int(p), strand) for p in pos)
        total += len(hits)
        if args.count:
            print(
                json.dumps(
                    {"record": name.decode(errors="replace"), **{
                        ("fwd" if s == "+" else "rev"): c
                        for s, c in counts.items()
                    }}
                )
            )
        else:
            for p, strand in sorted(hits):
                print(
                    json.dumps(
                        {
                            "record": name.decode(errors="replace"),
                            "pos": p,
                            "strand": strand,
                        }
                    )
                )
    return 0 if total or args.count else 1


def cmd_approx(args) -> int:
    """Best approximate occurrence of a query in every record: Myers
    bit-parallel semiglobal alignment on the PACKED words (``ops.align`` —
    no decode pass).  On 2-bit containers ``N`` in the *query* matches any
    base; on base-5 containers ``N`` is a literal (the codec has a real N
    digit) and ``?`` the wildcard — the ``grep`` conventions.  Prints one
    JSON line per record — minimum edit distance, match end position,
    strand (best strand under ``--both``); ``--max-errors E`` keeps only
    records with distance <= E (exit 1 when none qualify)."""
    import jax.numpy as jnp

    from .ops import align, spec

    codec, entries = read_nup(args.input)
    is_b5 = codec != "2bit"
    if args.all:
        if args.max_errors < 0:
            print("error: --all requires --max-errors", file=sys.stderr)
            return 1
        if args.cigar:
            print(
                "error: --all and --cigar are mutually exclusive (the "
                "all-ends scan has no single match to trace back)",
                file=sys.stderr,
            )
            return 1
        if is_b5:
            print(
                "error: --all is 2-bit only (the base-5 scan does not "
                "emit per-position scores)",
                file=sys.stderr,
            )
            return 1
    compile_q = align.peq_from_bytes_b5 if is_b5 else align.peq_from_bytes
    best_peq = align.best_match_peq_b5 if is_b5 else align.best_match_peq
    raw = args.pattern.encode()
    try:
        strands = [(compile_q(raw), "+", raw)]
        if args.both:
            rc = _revcomp_pattern(raw, is_b5)
            if rc != raw.upper().replace(b"U", b"T"):
                strands.append((compile_q(rc), "-", rc))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    qbytes_by_strand = {strand: qb for _, strand, qb in strands}

    chunk = max(args.batch, 1)
    # strand constants are chunk-invariant: build them once
    dev_strands = [
        (
            jnp.broadcast_to(jnp.asarray(peq)[None], (chunk,) + peq.shape),
            jnp.full((chunk,), m, jnp.int32),
            strand,
        )
        for (peq, m), strand, _qb in strands
    ]
    shown = 0
    for lo in range(0, len(entries), chunk):
        part = entries[lo : lo + chunk]
        lens = np.array([length for _, length, _ in part], np.int64)
        # u32 row width: next power of two (even, >= 2) buckets the
        # retraces — one compile per (chunk, width, strand-count)
        words_for = spec.num_words_b5 if is_b5 else spec.num_words_2bit
        need = max(2, int(2 * words_for(int(lens.max(initial=1)))))
        width = 2
        while width < need:
            width *= 2
        mat = np.zeros((chunk, width), np.uint32)
        for i, (_, _, words) in enumerate(part):
            w32 = spec.u64_to_u32_pairs(np.ascontiguousarray(words))
            mat[i, : 2 * len(words)] = w32.reshape(-1)
        tl = np.zeros(chunk, np.int32)
        tl[: len(part)] = lens
        tw_dev, tl_dev = jnp.asarray(mat), jnp.asarray(tl)
        if args.all:
            # every qualifying end per record/strand, not just the best
            errs = jnp.full((chunk,), args.max_errors, jnp.int32)
            for peq_dev, ql_dev, strand in dev_strands:
                ends = np.asarray(
                    align.match_ends_peq(
                        peq_dev, ql_dev, tw_dev, tl_dev, errs
                    )
                )
                for i, (name, _length, _words) in enumerate(part):
                    for j in np.nonzero(ends[i])[0]:
                        shown += 1
                        print(
                            json.dumps(
                                {
                                    "record": name.decode(errors="replace"),
                                    "end": int(j) + 1,
                                    "strand": strand,
                                }
                            )
                        )
            continue
        results = []  # per strand: (dist [B], end [B], strand)
        for peq_dev, ql_dev, strand in dev_strands:
            d, e = best_peq(peq_dev, ql_dev, tw_dev, tl_dev)
            results.append((np.asarray(d), np.asarray(e), strand))
        for i, (name, _length, words) in enumerate(part):
            best = None
            for d, e, strand in results:
                if best is None or int(d[i]) < best[0]:
                    best = (int(d[i]), int(e[i]), strand)
            dist, end, strand = best
            if args.max_errors >= 0 and dist > args.max_errors:
                continue
            shown += 1
            line = {
                "record": name.decode(errors="replace"),
                "dist": dist,
                "end": end,
                "strand": strand,
            }
            if args.cigar and end > 0:
                # tiny host DP on the <= 2m-1 window ending at the
                # device-reported end (coordinates stay forward-strand,
                # the SAM convention for reverse-strand hits)
                from .ops import oracle

                qb = qbytes_by_strand[strand]
                mq = len(qb)
                e_lo = max(0, end - (2 * mq - 1))
                nt_w = (
                    spec.NT_PER_WORD_B5 if is_b5 else spec.NT_PER_WORD_2BIT
                )
                a = (e_lo // nt_w) * nt_w
                decode = oracle.bits_to_n2_lut if is_b5 else oracle.bits_to_n_lut
                trace = (
                    align.semiglobal_traceback_b5
                    if is_b5
                    else align.semiglobal_traceback
                )
                dec = decode(
                    np.ascontiguousarray(words[a // nt_w:]), end - a
                )
                window = bytes(dec)[e_lo - a:]
                _d2, s2, _e2, cig = trace(qb, window)
                line["start"] = e_lo + s2
                line["cigar"] = cig
            print(json.dumps(line))
    if args.max_errors >= 0 and shown == 0:
        return 1
    return 0


def cmd_dedup(args) -> int:
    """Remove exact-duplicate records (same normalized sequence) from a
    .nup container — ``seqkit rmdup -s`` on the packed domain.  Equality
    is over the packed words + length (case/U folding happened at encode
    time), decided by one stable device sort (``ops.seqops.duplicate_mask``);
    first occurrence wins.  Prints a one-line JSON summary."""
    import jax.numpy as jnp

    from .ops import seqops, spec

    codec, entries = read_nup(args.input)
    if not entries:
        write_nup(args.output, [], [], [], codec)
        print(json.dumps({"records": 0, "kept": 0, "removed": 0}))
        return 0
    wmax = max(1, max(len(w) for _, _, w in entries))
    if wmax > 256:  # 2*wmax + 1 sort keys; compiles superlinearly beyond
        per_word = (
            spec.NT_PER_WORD_2BIT if codec == "2bit" else spec.NT_PER_WORD_B5
        )
        print(
            f"error: dedup is read-batch-scoped (records up to "
            f"{per_word * 256} nt for this codec); longest record here is "
            f"{max(length for _, length, _ in entries)} nt",
            file=sys.stderr,
        )
        return 1
    rows = np.zeros((len(entries), 2 * wmax), np.uint32)
    lens = np.zeros(len(entries), np.int64)
    for i, (_, length, words) in enumerate(entries):
        w32 = spec.u64_to_u32_pairs(np.ascontiguousarray(words)).reshape(-1)
        rows[i, : w32.size] = w32
        lens[i] = length
    dup = np.asarray(
        seqops.duplicate_mask(jnp.asarray(rows), jnp.asarray(lens, np.int32))
    )
    keep = [e for e, d in zip(entries, dup) if not d]
    write_nup(
        args.output,
        [n for n, _, _ in keep],
        [w for _, _, w in keep],
        [length for _, length, _ in keep],
        codec,
    )
    print(
        json.dumps(
            {
                "records": len(entries),
                "kept": len(keep),
                "removed": int(dup.sum()),
            }
        )
    )
    return 0


def cmd_bench(args) -> int:
    import runpy
    import os

    sys.argv = ["bench.py"]
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench.py")
    runpy.run_path(path, run_name="__main__")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cute-nucleotides-jax")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="encode reads to a packed .nup file")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument("--codec", choices=["2bit", "base5"], default="2bit")
    pe.add_argument("--tier", default="xla", choices=_TIERS)
    pe.add_argument("--validate", action="store_true")
    pe.add_argument(
        "--batch", type=int, default=0,
        help="device batch size (0 = per-record host path); uses the codec "
             "models with fixed-shape padded batches",
    )
    pe.add_argument("--max-len", type=int, default=65536)
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode", help="decode a .nup file to FASTA")
    pd.add_argument("input")
    pd.add_argument("output", nargs="?", default="-")
    pd.add_argument("--tier", default="xla", choices=_TIERS)
    pd.add_argument(
        "--verify-stream",
        action="store_true",
        help="scan base-5 streams for corrupt words before decoding",
    )
    pd.add_argument(
        "--batch", type=int, default=0, metavar="N",
        help="decode in fixed-shape device batches of N records "
             "(the production path, symmetric to `encode --batch`)",
    )
    pd.set_defaults(fn=cmd_decode)

    pp = sub.add_parser("parity", help="randomized oracle parity gate")
    pp.add_argument("--trials", type=int, default=50)
    pp.add_argument("--max-len", type=int, default=5000)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--tiers", default="xla")
    pp.set_defaults(fn=cmd_parity)

    ps = sub.add_parser("stats", help="packed-domain GC content + top k-mers")
    ps.add_argument("input")
    ps.add_argument("-k", type=int, default=8)
    ps.add_argument("--top", type=int, default=5)
    ps.add_argument("--canonical", action="store_true")
    ps.add_argument("--tier", default="xla", choices=_TIERS)
    ps.set_defaults(fn=cmd_stats)

    pr = sub.add_parser(
        "region",
        help="extract subsequences (NAME:START-END) on the packed domain",
    )
    pr.add_argument("input")
    pr.add_argument("regions", nargs="+", metavar="NAME:START-END")
    pr.add_argument("-o", "--output", default="-")
    pr.add_argument(
        "--packed", action="store_true",
        help="write a .nup of the still-packed windows instead of FASTA",
    )
    pr.add_argument("--tier", default="xla", choices=_TIERS)
    pr.set_defaults(fn=cmd_region)

    pg = sub.add_parser(
        "grep",
        help="find a pattern in packed records, no decode (2-bit: N = "
        "wildcard; base-5: N literal, ? = wildcard)",
    )
    pg.add_argument("input")
    pg.add_argument("pattern")
    pg.add_argument(
        "--both", action="store_true",
        help="also scan the reverse strand (revcomp pattern, + / - in output)",
    )
    pg.add_argument(
        "--count", action="store_true",
        help="print per-record totals instead of individual hits",
    )
    pg.add_argument(
        "--batch", type=int, default=0, metavar="N",
        help="scan N records per device call (fixed-shape batches; one "
        "dispatch per batch+strand instead of one per record)",
    )
    pg.set_defaults(fn=cmd_grep)

    pa = sub.add_parser(
        "approx",
        help="best approximate occurrence of a query per record (Myers "
        "bit-parallel edit distance on packed words; N in query = any)",
    )
    pa.add_argument("input", help=".nup container (either codec)")
    pa.add_argument(
        "pattern",
        help="query (2-bit: N = any base; base-5: N literal, ? = any)",
    )
    pa.add_argument(
        "--both", action="store_true",
        help="also align the reverse strand; report each record's best",
    )
    pa.add_argument(
        "--max-errors", type=int, default=-1, metavar="E",
        help="only report records with edit distance <= E (exit 1 if none)",
    )
    pa.add_argument(
        "--all", action="store_true",
        help="report EVERY end position within --max-errors, not just "
        "each record's best (2-bit containers)",
    )
    pa.add_argument(
        "--cigar", action="store_true",
        help="add match start + SAM CIGAR (host DP on the <= 2m-1 nt "
        "window around each reported end; reverse-strand hits stay in "
        "forward coordinates)",
    )
    pa.add_argument(
        "--batch", type=int, default=128, metavar="N",
        help="records per device call (fixed-shape batches)",
    )
    pa.set_defaults(fn=cmd_approx)

    pt = sub.add_parser(
        "translate",
        help="translate .nup records to protein FASTA (packed-domain codons)",
    )
    pt.add_argument("input")
    pt.add_argument("output", nargs="?", default="-")
    pt.add_argument(
        "--frames",
        default="1",
        help="'all' or comma list from 1,2,3,-1,-2,-3 (EMBOSS numbering)",
    )
    pt.set_defaults(fn=cmd_translate)

    pk = sub.add_parser(
        "sketch",
        help="MinHash-sketch datasets and estimate pairwise similarity "
        "(Jaccard / containment / Mash distance) from packed k-mers",
    )
    pk.add_argument(
        "inputs", nargs="+", metavar="READS",
        help="FASTA/FASTQ files (k-mers touching N are skipped, the "
        "Mash rule) or 2-bit .nup containers (which cannot hold N — "
        "encode them with --validate)",
    )
    pk.add_argument("-k", type=int, default=21, help="k-mer size (<= 31)")
    pk.add_argument(
        "-s", type=int, default=1000,
        help="sketch size (bottom-s) or buffer capacity (--scale mode)",
    )
    pk.add_argument(
        "--scale", type=int, default=0, metavar="N",
        help="FracMinHash mode: keep hashes below 2^32/N (sourmash's "
        "scheme; better containment across dataset sizes)",
    )
    pk.add_argument("--no-canonical", action="store_true",
                    help="hash forward-strand k-mers only")
    pk.add_argument("--batch", type=int, default=256,
                    help="reads per device batch")
    pk.add_argument(
        "--tier", default="auto", choices=["auto", "xla"],
        help="codec-model tier for encoding ASCII inputs",
    )
    pk.set_defaults(fn=cmd_sketch)

    pu = sub.add_parser(
        "dedup",
        help="remove exact-duplicate records (packed-word equality, "
        "first occurrence wins)",
    )
    pu.add_argument("input", help=".nup container (either codec)")
    pu.add_argument("output", help="deduplicated .nup")
    pu.set_defaults(fn=cmd_dedup)

    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from .utils import compile_cache

    compile_cache.enable()
    try:
        return args.fn(args)
    except BrokenPipeError:
        # downstream pipe closed early (e.g. `decode out.nup - | head`):
        # the conventional exit for SIGPIPE, not a traceback
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 141
    except (ValueError, KeyError, OSError) as e:
        # malformed/truncated containers, missing files: a one-line
        # error + nonzero exit, not a traceback (NupReader raises lazily
        # at record access, so per-command wrapping can't cover it)
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
