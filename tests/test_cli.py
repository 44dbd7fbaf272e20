"""CLI: encode -> .nup container -> decode roundtrip, parity gate."""

import json
import os

import numpy as np
import pytest

from cute_nucleotides_jax import cli
from cute_nucleotides_jax.ops import oracle


def test_nup_roundtrip(tmp_path):
    names = [b"r1", b"read two"]
    seqs = [b"ACGTACGTAC", b"GG"]
    words = [oracle.n_to_bits_lut(np.frombuffer(s, np.uint8)) for s in seqs]
    p = str(tmp_path / "x.nup")
    cli.write_nup(p, names, words, [len(s) for s in seqs], "2bit")
    codec, entries = cli.read_nup(p)
    assert codec == "2bit"
    assert [e[0] for e in entries] == names
    assert [e[1] for e in entries] == [10, 2]
    for (name, length, w), want in zip(entries, words):
        assert np.array_equal(w, want)


def test_cli_encode_decode(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\nACGTacgtUU\n>b\nGGGGCCCC\n")
    nup = str(tmp_path / "out.nup")
    out_fa = str(tmp_path / "out.fa")
    assert cli.main(["encode", str(fa), nup, "--codec", "2bit", "--tier", "oracle"]) == 0
    info = json.loads(capsys.readouterr().out.strip())
    assert info["records"] == 2 and info["nt"] == 18
    assert cli.main(["decode", nup, out_fa, "--tier", "oracle"]) == 0
    text = open(out_fa, "rb").read()
    assert text == b">a\nACGTACGTTT\n>b\nGGGGCCCC\n"


def test_cli_validate_rejects(tmp_path, capsys):
    fa = tmp_path / "bad.fa"
    fa.write_bytes(b">a\nACGTX\n")
    rc = cli.main(
        ["encode", str(fa), str(tmp_path / "o.nup"), "--validate", "--tier", "oracle"]
    )
    assert rc == 1


def test_cli_parity_gate(capsys):
    rc = cli.main(["parity", "--trials", "6", "--max-len", "300", "--tiers", "xla"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["parity"] == "PASS"


def test_nup_rejects_garbage(tmp_path):
    p = tmp_path / "bad.nup"
    p.write_bytes(b"NOPE1234")
    with pytest.raises(ValueError):
        cli.read_nup(str(p))


def test_nup_rejects_bad_version(tmp_path):
    import struct

    p = tmp_path / "v9.nup"
    p.write_bytes(cli.MAGIC + struct.pack("<IB3x", 99, 2) + struct.pack("<Q", 0))
    with pytest.raises(ValueError):
        cli.read_nup(str(p))


def test_cli_encode_batch_mode(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\nACGTacgtUU\n>b\nGGGGCCCC\n>c\n" + b"ACGTN" * 30 + b"\n")
    nup = str(tmp_path / "out.nup")
    rc = cli.main(
        ["encode", str(fa), nup, "--codec", "base5", "--tier", "xla",
         "--batch", "8", "--max-len", "256"]
    )
    assert rc == 0
    codec, entries = cli.read_nup(nup)
    assert codec == "base5" and len(entries) == 3
    for (name, length, words), seq in zip(
        entries, [b"ACGTacgtUU", b"GGGGCCCC", b"ACGTN" * 30]
    ):
        want = oracle.n_to_bits2_lut(np.frombuffer(seq, np.uint8))
        assert np.array_equal(words, want), name


def test_cli_stats(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\nACGTACGTACGT\n>b\nGGGGCC\n")
    rc = cli.main(["stats", str(fa), "-k", "2", "--top", "3"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["records"] == 2 and out["nt"] == 18
    assert abs(out["gc_fraction"] - 12 / 18) < 1e-6
    assert out["composition"] == {"A": 3, "C": 5, "T": 3, "G": 7}
    assert out["top_kmers"][0]["count"] >= 3
    assert all(len(t["kmer"]) == 2 for t in out["top_kmers"])


@pytest.mark.parametrize("codec", ["2bit", "base5"])
def test_cli_decode_batch_mode(tmp_path, codec):
    """decode --batch == per-record decode, ragged lengths + both codecs."""
    rng = np.random.default_rng(7)
    alpha = b"ACGTN" if codec == "base5" else b"ACGT"
    seqs = [
        bytes(rng.choice(np.frombuffer(alpha, np.uint8), n))
        for n in (1, 27, 100, 33, 5)
    ]
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))
    nup = str(tmp_path / "x.nup")
    assert cli.main(["encode", str(fa), nup, "--codec", codec]) == 0
    ref_fa = str(tmp_path / "ref.fa")
    got_fa = str(tmp_path / "got.fa")
    assert cli.main(["decode", nup, ref_fa]) == 0
    assert cli.main(["decode", nup, got_fa, "--batch", "3"]) == 0
    assert open(got_fa, "rb").read() == open(ref_fa, "rb").read()


def test_cli_validate_batch_rejects(tmp_path, capsys):
    fa = tmp_path / "bad.fa"
    fa.write_bytes(b">a\nACGTACGT\n>b\nACGTXCGT\n")
    rc = cli.main(
        ["encode", str(fa), str(tmp_path / "o.nup"), "--validate",
         "--batch", "2", "--tier", "xla"]
    )
    assert rc == 1
    assert "invalid byte" in capsys.readouterr().err


def test_cli_validate_batch_accepts(tmp_path, capsys):
    fa = tmp_path / "ok.fa"
    fa.write_bytes(b">a\nACGTacgtUU\n>b\nGGGGCCCC\n")
    nup = str(tmp_path / "o.nup")
    rc = cli.main(
        ["encode", str(fa), nup, "--validate", "--batch", "2", "--tier", "xla"]
    )
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip())
    assert info["records"] == 2


def test_cli_decode_verify_stream(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\nACGTNACGTNACGTNACGTNACGTNAC\n")
    nup = str(tmp_path / "o.nup")
    assert cli.main(["encode", str(fa), nup, "--codec", "base5", "--tier", "oracle"]) == 0
    capsys.readouterr()
    out_fa = str(tmp_path / "out.fa")
    assert cli.main(["decode", nup, out_fa, "--verify-stream", "--tier", "oracle"]) == 0
    # corrupt the stream: set an out-of-range triplet value in the payload
    blob = bytearray(open(nup, "rb").read())
    blob[-8] = 125  # lowest 7 bits of the first (only) word -> invalid
    bad_nup = str(tmp_path / "bad.nup")
    open(bad_nup, "wb").write(bytes(blob))
    rc = cli.main(["decode", bad_nup, out_fa, "--verify-stream", "--tier", "oracle"])
    assert rc == 1
    assert "corrupt base-5 word 0" in capsys.readouterr().err


def test_cli_stats_production_k(tmp_path, capsys):
    """k > 12 routes through kmer_counts (sorted-segment, no dense array)."""
    fa = tmp_path / "in.fa"
    seq = b"ACGTACGTACGTACGTACGTACGT"  # 24 nt, repeating period 4
    fa.write_bytes(b">a\n" + seq + b"\n")
    rc = cli.main(["stats", str(fa), "-k", "21", "--top", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["k"] == 21 and out["distinct_kmers"] == 4
    assert sum(t["count"] for t in out["top_kmers"]) == 2
    top = out["top_kmers"][0]["kmer"]
    assert len(top) == 21 and seq.decode().find(top) >= 0


@pytest.mark.parametrize("codec", ["2bit", "base5"])
def test_cli_region(tmp_path, codec):
    fa = tmp_path / "in.fa"
    seq = b"ACGTACGTACGTAAACCCGGGTTTACGTACGTNNNACGT"
    body = seq if codec == "base5" else seq.replace(b"N", b"G")
    fa.write_bytes(b">chr1\n" + body + b"\n>chr2\nACGTACGT\n")
    nup = str(tmp_path / "x.nup")
    assert cli.main(
        ["encode", str(fa), nup, "--codec", codec, "--tier", "oracle"]
    ) == 0
    out_fa = str(tmp_path / "r.fa")
    assert cli.main(
        ["region", nup, "chr1:5-20", "chr2:0-8", "-o", out_fa]
    ) == 0
    text = open(out_fa, "rb").read()
    assert text == (
        b">chr1:5-20\n" + body[5:20] + b"\n>chr2:0-8\nACGTACGT\n"
    )


def test_cli_region_packed_roundtrip(tmp_path):
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">c\n" + b"ACGT" * 30 + b"\n")
    nup = str(tmp_path / "x.nup")
    assert cli.main(["encode", str(fa), nup, "--tier", "oracle"]) == 0
    sub = str(tmp_path / "sub.nup")
    assert cli.main(["region", nup, "c:7-53", "--packed", "-o", sub]) == 0
    codec, entries = cli.read_nup(sub)
    assert codec == "2bit"
    (name, length, words) = entries[0]
    assert name == b"c:7-53" and length == 46
    got = oracle.bits_to_n_lut(words, length)
    assert bytes(got) == (b"ACGT" * 30)[7:53]


def test_cli_region_errors(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">c\nACGTACGT\n")
    nup = str(tmp_path / "x.nup")
    assert cli.main(["encode", str(fa), nup, "--tier", "oracle"]) == 0
    assert cli.main(["region", nup, "nope:0-4"]) == 1
    assert cli.main(["region", nup, "c:0-99"]) == 1
    with pytest.raises(ValueError):
        cli._parse_region("c")
    with pytest.raises(ValueError):
        cli._parse_region("c:5-2")


def test_cli_grep(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    #             0123456789...          GATTACA at 4; revcomp TGTAATC at 15
    fa.write_bytes(b">r1\nACGTGATTACAGGGGTGTAATCCC\n>r2\nAAAA\n")
    nup = str(tmp_path / "x.nup")
    assert cli.main(["encode", str(fa), nup, "--tier", "oracle"]) == 0
    capsys.readouterr()  # flush the encode summary line
    assert cli.main(["grep", nup, "GATTACA", "--both"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert {(d["record"], d["pos"], d["strand"]) for d in lines} == {
        ("r1", 4, "+"), ("r1", 15, "-"),
    }
    # wildcard pattern + per-record counts
    assert cli.main(["grep", nup, "GNTTANA", "--count"]) == 0
    counts = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert counts == [{"record": "r1", "fwd": 1}, {"record": "r2", "fwd": 0}]
    # batched path: identical hit set, one device call per batch+strand
    assert cli.main(["grep", nup, "GATTACA", "--both", "--batch", "2"]) == 0
    blines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert {(d["record"], d["pos"], d["strand"]) for d in blines} == {
        ("r1", 4, "+"), ("r1", 15, "-"),
    }
    assert cli.main(["grep", nup, "GNTTANA", "--count", "--batch", "8"]) == 0
    bcounts = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert bcounts == [{"record": "r1", "fwd": 1}, {"record": "r2", "fwd": 0}]
    # no hits -> exit 1; bad pattern -> exit 1
    assert cli.main(["grep", nup, "CCCCCCCCCC"]) == 1
    assert cli.main(["grep", nup, "CCCCCCCCCC", "--batch", "4"]) == 1
    assert cli.main(["grep", nup, "ACGX"]) == 1


def test_cli_grep_base5(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    #              GATTACA at 4 (fwd); revcomp TGTAATC at 15; N run at 24
    fa.write_bytes(b">r1\nACGTGATTACAGGGGTGTAATCCCNNA\n>r2\nAANAA\n")
    nup = str(tmp_path / "x.nup")
    assert cli.main(
        ["encode", str(fa), nup, "--codec", "base5", "--tier", "oracle"]
    ) == 0
    capsys.readouterr()
    assert cli.main(["grep", nup, "GATTACA", "--both"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert {(d["record"], d["pos"], d["strand"]) for d in lines} == {
        ("r1", 4, "+"), ("r1", 15, "-"),
    }
    # N is a LITERAL on base-5 streams; '?' is the wildcard
    assert cli.main(["grep", nup, "NN", "--count"]) == 0
    counts = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert counts == [{"record": "r1", "fwd": 1}, {"record": "r2", "fwd": 0}]
    assert cli.main(["grep", nup, "G?TTA?A", "--count"]) == 0
    counts = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert counts == [{"record": "r1", "fwd": 1}, {"record": "r2", "fwd": 0}]
    # wildcard survives --both (revcomp of A?C finds G?T)
    assert cli.main(["grep", nup, "TG?AAT", "--both"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert ("r1", 15, "+") in {(d["record"], d["pos"], d["strand"]) for d in lines}
    # batched base-5 path: identical hits
    assert cli.main(["grep", nup, "G?TTA?A", "--batch", "2"]) == 0
    blines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert {(d["record"], d["pos"], d["strand"]) for d in blines} == {
        ("r1", 4, "+"),
    }
    # bad pattern (X not in alphabet) -> exit 1
    assert cli.main(["grep", nup, "ACGX"]) == 1


def test_nup_reader_random_access(tmp_path):
    names = [b"a", b"b", b"dup", b"dup"]
    seqs = [b"ACGTN" * 7, b"N" * 28, b"ACG", b"TTT"]
    words = [oracle.n_to_bits2_lut(np.frombuffer(s, np.uint8)) for s in seqs]
    p = str(tmp_path / "r.nup")
    cli.write_nup(p, names, words, [len(s) for s in seqs], "base5")
    with cli.NupReader(p) as r:
        assert r.codec == "base5"
        assert len(r) == 4
        assert r.names == names and r.lengths == [35, 28, 3, 3]
        # out-of-order random access returns exactly each record's words
        assert np.array_equal(r.words(2), words[2])
        assert np.array_equal(r.words(0), words[0])
        length, w = r.get(b"b")
        assert length == 28 and np.array_equal(w, words[1])
        # duplicate names resolve to the first occurrence
        assert np.array_equal(r.get(b"dup")[1], words[2])
        assert b"a" in r and b"zzz" not in r
        with pytest.raises(KeyError):
            r.get(b"zzz")
        # iteration matches the eager reader
        assert [(n, L) for n, L, _ in r] == [(n, len(s)) for n, s in zip(names, seqs)]
    codec, entries = cli.read_nup(p)
    assert codec == "base5" and [e[0] for e in entries] == names


def test_cli_tier_choices_match_api():
    from cute_nucleotides_jax import api

    assert cli._TIERS == api._TIERS
    # a typo'd tier dies as a clean argparse usage error, before any
    # output file is opened
    with pytest.raises(SystemExit):
        cli.main(["region", "x.nup", "chr1:0-5", "-o", "y.fa", "--tier", "pallsa"])


def test_cli_decode_batch_fused_verify(tmp_path, capsys):
    """--batch --verify-stream rides the FUSED checked decode: clean streams
    decode identically, corrupt streams die with the diagnosed record."""
    fa = tmp_path / "in.fa"
    fa.write_bytes(
        b">a\nACGTNACGTNACGTNACGTNACGTNAC\n>b\nNNNACGTACGTACGT\n"
    )
    nup = str(tmp_path / "o.nup")
    assert cli.main(["encode", str(fa), nup, "--codec", "base5", "--tier", "oracle"]) == 0
    capsys.readouterr()
    out_fa = str(tmp_path / "out.fa")
    assert cli.main(
        ["decode", nup, out_fa, "--verify-stream", "--batch", "4", "--tier", "auto"]
    ) == 0
    plain = str(tmp_path / "plain.fa")
    assert cli.main(["decode", nup, plain, "--batch", "4", "--tier", "auto"]) == 0
    assert open(out_fa, "rb").read() == open(plain, "rb").read()
    # corrupt record b's word: pad bit 63 of its (only) u64 word
    blob = bytearray(open(nup, "rb").read())
    blob[-1] |= 0x80
    bad_nup = str(tmp_path / "bad.nup")
    open(bad_nup, "wb").write(bytes(blob))
    before = open(out_fa, "rb").read()  # pre-existing output must survive
    rc = cli.main(
        ["decode", bad_nup, out_fa, "--verify-stream", "--batch", "4", "--tier", "auto"]
    )
    assert rc == 1
    err = capsys.readouterr().err
    assert "corrupt base-5 word 0 in record b" in err
    # the abort neither clobbered the existing file nor left a temp behind
    assert open(out_fa, "rb").read() == before
    assert not (tmp_path / "out.fa.tmp").exists()


def test_cli_translate(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">g1\nATGAANTGGTAA\n")
    nup = str(tmp_path / "o.nup")
    assert cli.main(["encode", str(fa), nup, "--codec", "base5", "--tier", "oracle"]) == 0
    capsys.readouterr()
    out_fa = str(tmp_path / "p.fa")
    assert cli.main(["translate", nup, out_fa]) == 0
    assert open(out_fa, "rb").read() == b">g1|frame=+1\nMXW*\n"
    assert cli.main(["translate", nup, out_fa, "--frames", "all"]) == 0
    body = open(out_fa, "rb").read()
    assert body.count(b">") == 6 and b"|frame=-1\n" in body
    # 2-bit container path + bad frame spec
    nup2 = str(tmp_path / "o2.nup")
    fa2 = tmp_path / "in2.fa"
    fa2.write_bytes(b">g2\nATGTGGTAA\n")
    assert cli.main(["encode", str(fa2), nup2, "--tier", "oracle"]) == 0
    assert cli.main(["translate", nup2, out_fa, "--frames", "2,-3"]) == 0
    assert open(out_fa, "rb").read().count(b">") == 2
    assert cli.main(["translate", nup2, out_fa, "--frames", "4"]) == 2


def test_cli_sketch_pairwise(tmp_path, capsys):
    """Identical datasets -> Jaccard 1 / distance 0; disjoint ones -> ~0.
    Also exercises the .nup input path against the FASTA path."""
    rng = np.random.default_rng(7)
    a = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400))
    b = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400))
    fa_a = tmp_path / "a.fa"
    fa_a.write_bytes(b">a\n" + a + b"\n")
    fa_a2 = tmp_path / "a2.fa"
    fa_a2.write_bytes(b">a\n" + a + b"\n")
    fa_b = tmp_path / "b.fa"
    fa_b.write_bytes(b">b\n" + b + b"\n")
    rc = cli.main(
        ["sketch", str(fa_a), str(fa_a2), str(fa_b), "-k", "11", "-s", "64",
         "--batch", "4", "--tier", "xla"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert [d["records"] for d in out["datasets"]] == [1, 1, 1]
    assert [d["nt"] for d in out["datasets"]] == [400, 400, 400]
    pairs = {(p["a"], p["b"]): p for p in out["pairs"]}
    same = pairs[(str(fa_a), str(fa_a2))]
    assert same["jaccard"] == 1.0 and same["mash_distance"] == 0.0
    assert pairs[(str(fa_a), str(fa_b))]["jaccard"] < 0.2

    # .nup input must sketch identically to its FASTA source
    nup = str(tmp_path / "a.nup")
    assert cli.main(["encode", str(fa_a), nup, "--tier", "oracle"]) == 0
    capsys.readouterr()
    rc = cli.main(
        ["sketch", nup, str(fa_a), "-k", "11", "-s", "64",
         "--batch", "4", "--tier", "xla"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["pairs"][0]["jaccard"] == 1.0


def test_cli_sketch_frac_mode(tmp_path, capsys):
    rng = np.random.default_rng(11)
    big = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=600))
    sub = big[100:300]
    f_big = tmp_path / "big.fa"
    f_big.write_bytes(b">g\n" + big + b"\n")
    f_sub = tmp_path / "sub.fa"
    f_sub.write_bytes(b">s\n" + sub + b"\n")
    rc = cli.main(
        ["sketch", str(f_sub), str(f_big), "-k", "9", "-s", "1024",
         "--scale", "1", "--tier", "xla"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["scheme"]["name"] == "fracminhash"
    # scale=1 keeps every hash -> containment of a true substring is exact
    assert out["pairs"][0]["containment_a_in_b"] == 1.0
    assert out["pairs"][0]["jaccard"] < 1.0


def test_cli_sketch_rejects_base5_nup(tmp_path, capsys):
    fa = tmp_path / "n.fa"
    fa.write_bytes(b">n\nACGTNNACGTACGTACGTACGTACGTACGT\n")
    nup = str(tmp_path / "n.nup")
    assert cli.main(
        ["encode", str(fa), nup, "--codec", "base5", "--tier", "oracle"]
    ) == 0
    capsys.readouterr()
    assert cli.main(["sketch", nup, "-k", "5"]) == 1


def test_cli_sketch_skips_n_kmers(tmp_path, capsys):
    """N runs must not manufacture similarity (review finding: 2-bit
    packing aliases N to G; the byte mask keeps those k-mers out)."""
    rng = np.random.default_rng(5)
    a = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200))
    b = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200))
    n_run = b"N" * 120
    fa = tmp_path / "a.fa"
    fa.write_bytes(b">a\n" + a + n_run + b"\n")
    fb = tmp_path / "b.fa"
    fb.write_bytes(b">b\n" + b + n_run + b"\n")
    rc = cli.main(
        ["sketch", str(fa), str(fb), "-k", "11", "-s", "512",
         "--tier", "xla"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    # shared poly-N tails would alias to shared poly-G k-mers; masked,
    # two random 200-nt sequences share essentially nothing
    assert out["pairs"][0]["jaccard"] < 0.05
    # and each dataset keeps only its valid-window hashes (~190 per side)
    assert all(d["hashes"] < 400 for d in out["datasets"])


def test_cli_sketch_survives_empty_records(tmp_path, capsys):
    fa = tmp_path / "e.fa"
    fa.write_bytes(b">empty\n\n>tiny\nACG\n>real\n" + b"ACGTAGGTCA" * 6 + b"\n")
    nup = str(tmp_path / "e.nup")
    assert cli.main(["encode", str(fa), nup, "--tier", "oracle"]) == 0
    capsys.readouterr()
    rc = cli.main(
        ["sketch", nup, str(fa), "-k", "5", "-s", "32", "--batch", "1",
         "--tier", "xla"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert [d["records"] for d in out["datasets"]] == [3, 3]
    # the two views of the same data must sketch identically
    assert out["pairs"][0]["jaccard"] == 1.0


def test_cli_sketch_frac_saturation_warns(tmp_path, capsys):
    rng = np.random.default_rng(13)
    g = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=800))
    fa = tmp_path / "g.fa"
    fa.write_bytes(b">g\n" + g + b"\n")
    rc = cli.main(
        ["sketch", str(fa), "-k", "9", "-s", "64", "--scale", "1",
         "--tier", "xla"]
    )
    assert rc == 0
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip())
    assert out["datasets"][0]["saturated"] is True
    assert "saturated" in cap.err


def test_cli_approx(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    #             0123456789...          GATTACA at 4; revcomp TGTAATC at 15
    fa.write_bytes(b">r1\nACGTGATTACAGGGGTGTAATCCC\n>r2\nAAAA\n")
    nup = str(tmp_path / "x.nup")
    assert cli.main(["encode", str(fa), nup, "--tier", "oracle"]) == 0
    capsys.readouterr()
    # exact occurrence -> dist 0, end just past it
    assert cli.main(["approx", nup, "GATTACA"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert lines[0] == {"record": "r1", "dist": 0, "end": 11, "strand": "+"}
    assert lines[1]["record"] == "r2" and lines[1]["dist"] > 0
    # one substitution in the query -> dist 1
    assert cli.main(["approx", nup, "GATTCCA"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["dist"] == 1
    # reverse strand wins under --both: rc(GGATTACA) = TGTAATCC at 15..22
    assert cli.main(["approx", nup, "GGATTACA", "--both"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["dist"] == 0 and lines[0]["strand"] == "-"
    # N wildcard in the query
    assert cli.main(["approx", nup, "GANTACA"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["dist"] == 0
    # --max-errors filter + exit codes; tiny --batch exercises chunking
    assert cli.main(["approx", nup, "GATTCCA", "--max-errors", "1",
                     "--batch", "1"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert [d["record"] for d in lines] == ["r1"]
    assert cli.main(["approx", nup, "CCCCCCCCCC", "--max-errors", "0"]) == 1
    capsys.readouterr()
    # bad query -> exit 1
    assert cli.main(["approx", nup, "ACGX"]) == 1


def test_cli_approx_base5(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    #               GATNACA at 4 (N literal survives the base-5 codec)
    fa.write_bytes(b">r1\nACGTGATNACAGGGG\n>r2\nAAAA\n")
    nup = str(tmp_path / "x5.nup")
    assert cli.main(
        ["encode", str(fa), nup, "--codec", "base5", "--tier", "oracle"]
    ) == 0
    capsys.readouterr()
    # N literal: only the exact N-bearing query hits at distance 0
    assert cli.main(["approx", nup, "GATNACA", "--cigar"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert (lines[0]["dist"], lines[0]["start"], lines[0]["end"],
            lines[0]["cigar"]) == (0, 4, 11, "7M")
    # an A in place of the N is a mismatch against the literal N
    assert cli.main(["approx", nup, "GATAACA"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["dist"] == 1
    # '?' is the wildcard on base-5: matches the N for free
    assert cli.main(["approx", nup, "GAT?ACA", "--cigar"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["dist"] == 0 and lines[0]["cigar"] == "7M"
    # reverse strand on base-5 under --both
    assert cli.main(["approx", nup, "TGTNATC", "--both"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["dist"] == 0 and lines[0]["strand"] == "-"


def test_cli_approx_cigar(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">r1\nACGTGATTACAGGGGTGTAATCCC\n")
    nup = str(tmp_path / "x.nup")
    assert cli.main(["encode", str(fa), nup, "--tier", "oracle"]) == 0
    capsys.readouterr()
    # exact hit: 7M starting at 4
    assert cli.main(["approx", nup, "GATTACA", "--cigar"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert (d["dist"], d["start"], d["end"], d["cigar"]) == (0, 4, 11, "7M")
    # substitution stays M; an inserted query base shows up as I
    assert cli.main(["approx", nup, "GATTAACA", "--cigar"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert d["dist"] == 1 and "I" in d["cigar"]
    msum = sum(
        int(n) for n, op in __import__("re").findall(r"(\d+)([MID])", d["cigar"])
        if op in "MI"
    )
    assert msum == 8  # M + I consume the whole query


def test_cli_dedup(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    # r2 duplicates r1 after case/U folding; r4 duplicates r3; r5 unique
    fa.write_bytes(
        b">r1\nACGTACGTAC\n>r2\nacguacguac\n>r3\nGGGG\n>r4\nGGGG\n"
        b">r5\nGGG\n"
    )
    nup = str(tmp_path / "x.nup")
    out = str(tmp_path / "dedup.nup")
    assert cli.main(["encode", str(fa), nup, "--tier", "oracle"]) == 0
    capsys.readouterr()
    assert cli.main(["dedup", nup, out]) == 0
    info = json.loads(capsys.readouterr().out.strip())
    assert info == {"records": 5, "kept": 3, "removed": 2}
    codec, entries = cli.read_nup(out)
    assert [e[0] for e in entries] == [b"r1", b"r3", b"r5"]
    assert [e[1] for e in entries] == [10, 4, 3]
    # roundtrip: surviving records decode to the folded originals
    out_fa = str(tmp_path / "out.fa")
    assert cli.main(["decode", out, out_fa, "--tier", "oracle"]) == 0
    assert open(out_fa, "rb").read() == (
        b">r1\nACGTACGTAC\n>r3\nGGGG\n>r5\nGGG\n"
    )


def test_cli_approx_all(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    # two exact GATTACA occurrences in one record
    fa.write_bytes(b">r1\nGGGGATTACAGGGGGATTACAGG\n")
    nup = str(tmp_path / "x.nup")
    assert cli.main(["encode", str(fa), nup, "--tier", "oracle"]) == 0
    capsys.readouterr()
    assert cli.main(
        ["approx", nup, "GATTACA", "--all", "--max-errors", "0"]
    ) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert {d["end"] for d in lines} == {10, 21}
    # --all at E=1 also catches 1-edit neighborhoods around each hit
    assert cli.main(
        ["approx", nup, "GATTACA", "--all", "--max-errors", "1"]
    ) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    ends = {d["end"] for d in lines}
    assert {10, 21} <= ends and len(ends) > 2
    # guards: --all without --max-errors, and on base-5 containers
    assert cli.main(["approx", nup, "GATTACA", "--all"]) == 1
    fa5 = tmp_path / "n.fa"
    fa5.write_bytes(b">r1\nACGTN\n")
    nup5 = str(tmp_path / "x5.nup")
    assert cli.main(
        ["encode", str(fa5), nup5, "--codec", "base5", "--tier", "oracle"]
    ) == 0
    capsys.readouterr()
    assert cli.main(
        ["approx", nup5, "ACG", "--all", "--max-errors", "0"]
    ) == 1


def test_cli_truncated_container_errors(tmp_path, capsys):
    """A truncated .nup must ERROR, not decode fabricated 'A' runs from
    zero padding (r05 review, reproduced pre-fix)."""
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\n" + b"ACGT" * 20 + b"\n>b\n" + b"GATTACA" * 10 + b"\n")
    nup = str(tmp_path / "t.nup")
    assert cli.main(["encode", str(fa), nup, "--codec", "2bit"]) == 0
    raw = open(nup, "rb").read()
    open(nup, "wb").write(raw[:-8])  # drop one packed word
    out_fa = str(tmp_path / "out.fa")
    rc = cli.main(["decode", nup, out_fa, "--batch", "4"])
    capsys.readouterr()
    assert rc != 0
    assert not os.path.exists(out_fa)  # tmp+rename: nothing half-written


def test_cli_batch_tier_oracle_rejected(tmp_path, capsys):
    """--batch has no oracle device path: clear error, not a KeyError
    crash (2-bit) or a silently-mislabeled XLA run (base-5)."""
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\nACGTACGT\n")
    nup = str(tmp_path / "o.nup")
    rc = cli.main(
        ["encode", str(fa), nup, "--batch", "4", "--tier", "oracle"]
    )
    assert rc == 2
    assert "oracle" in capsys.readouterr().err
    assert cli.main(["encode", str(fa), nup]) == 0
    capsys.readouterr()
    rc = cli.main(
        ["decode", nup, str(tmp_path / "d.fa"), "--batch", "4",
         "--tier", "oracle"]
    )
    assert rc == 2
    assert "oracle" in capsys.readouterr().err


def test_cli_region_failure_preserves_output(tmp_path, capsys):
    """A failed region command must not truncate a pre-existing output
    file (r05 review: eager open-for-write clobbered it)."""
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">chr1\n" + b"ACGT" * 10 + b"\n")
    nup = str(tmp_path / "r.nup")
    assert cli.main(["encode", str(fa), nup]) == 0
    capsys.readouterr()
    out = tmp_path / "regions.fa"
    out.write_bytes(b">precious\nACGT\n")
    rc = cli.main(["region", nup, "MISSING:0-4", "-o", str(out)])
    capsys.readouterr()
    assert rc == 1
    assert out.read_bytes() == b">precious\nACGT\n"
    # and the success path still writes through the tmp rename
    assert cli.main(["region", nup, "chr1:0-8", "-o", str(out)]) == 0
    assert out.read_bytes().startswith(b">chr1:0-8\n")
