"""Packed-domain pattern search vs a naive host-side oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from cute_nucleotides_jax.ops import oracle, search, spec


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _enc(seq) -> jnp.ndarray:
    seq = np.frombuffer(bytes(seq), np.uint8) if isinstance(seq, bytes) else seq
    return jnp.asarray(
        spec.u64_to_u32_pairs(oracle.n_to_bits_lut(seq)).reshape(-1)
    )


def _naive(seq: bytes, query: bytes) -> np.ndarray:
    """All match positions of query (N = wildcard) in the normalized seq."""
    s = seq.upper().replace(b"U", b"T")
    q = query.upper().replace(b"U", b"T")
    out = []
    for i in range(len(s) - len(q) + 1):
        if all(qc in (ord("N"), sc) for sc, qc in zip(s[i:], q)):
            out.append(i)
    return np.asarray(out, dtype=np.int64)


def test_compile_query_packing():
    q, care, m = search.compile_query(b"ACGT" * 8 + b"NN")
    assert m == 34 and q.shape == (3,)
    # ACGT -> codes 0,1,3,2 LSB-first = 0b10_11_01_00 per 4 nt
    assert int(q[0]) == int(q[1]) == 0xB4B4B4B4
    assert int(care[0]) == 0xFFFFFFFF
    assert int(q[2]) == 0 and int(care[2]) == 0  # the two wildcards


def test_compile_query_rejects_junk():
    with pytest.raises(ValueError):
        search.compile_query(b"ACGTX")
    with pytest.raises(ValueError):
        search.compile_query(b"")


def test_revcomp_query():
    assert search.revcomp_query(b"AACGTN") == b"NACGTT"
    assert search.revcomp_query(b"acgu") == b"ACGT"


@pytest.mark.parametrize("query", [b"ACG", b"acgu", b"ANNT", b"GATTACA"])
def test_match_mask_basic(rng, query):
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=300))
    got = np.flatnonzero(np.asarray(search.match_mask(_enc(seq), len(seq), query)))
    assert np.array_equal(got, _naive(seq, query))


def test_match_mask_multiword_query(rng):
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=500))
    # plant a long query at known offsets, incl. an unaligned one
    query = seq[123:123 + 47]
    got = np.flatnonzero(np.asarray(search.match_mask(_enc(seq), len(seq), query)))
    want = _naive(seq, query)
    assert 123 in want and np.array_equal(got, want)


def test_match_bits_matches_mask(rng):
    """The packed-bitmask scan agrees with the gather mask."""
    for L, query in (
        (300, b"ACGT"),
        (9000, b"GATTACA"),
        (9000, b"ANNNT"),
        (700, b"TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT"),  # 35 nt, 3 words
    ):
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L))
        w = _enc(seq)
        mask = np.asarray(search.match_mask(w, L, query))
        bits = np.asarray(search.match_bits(w, L, query))
        pos = search.match_positions(w, L, query)
        assert np.array_equal(pos, np.flatnonzero(mask))
        # every set bit decodes to a masked position and vice versa
        total = int(np.bitwise_count(bits).sum()) if hasattr(np, "bitwise_count") \
            else sum(bin(int(v)).count("1") for v in bits.reshape(-1))
        assert total == int(mask.sum())
        assert int(search.match_count(w, L, query)) == int(mask.sum())


def test_match_bits_tail_padding_no_false_hits():
    """'A'-padding beyond the stream must not fabricate poly-A matches."""
    L = 40
    seq = b"C" * (L - 3) + b"AAA"
    w = _enc(seq)
    pos = search.match_positions(w, L, b"AAA")
    assert np.array_equal(pos, [L - 3])
    # a query of all-wildcards matches every valid start and nothing past it
    n = L - 3 + 1
    assert int(search.match_count(w, L, b"NNN")) == n


def test_match_fuzz(rng):
    for _ in range(40):
        L = int(rng.integers(20, 400))
        m = int(rng.integers(1, min(L, 70)))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTacgtu", np.uint8), size=L))
        qs = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=m)
        query = bytes(qs)
        w = _enc(seq)
        want = _naive(seq, query)
        assert np.array_equal(
            np.flatnonzero(np.asarray(search.match_mask(w, L, query))), want
        ), (L, query)
        assert np.array_equal(search.match_positions(w, L, query), want), (L, query)


def test_match_strand_composition(rng):
    """Reverse-strand hits = forward hits of the revcomp query."""
    seq = b"AAAAACGTAGGGTTTCCC" + b"GATTACA" + b"TTTT"
    w = _enc(seq)
    rc = search.revcomp_query(b"TGTAATC")  # revcomp -> GATTACA
    assert rc == b"GATTACA"
    pos = search.match_positions(w, len(seq), rc)
    assert np.array_equal(pos, [18])


def _enc5(seq) -> jnp.ndarray:
    seq = np.frombuffer(bytes(seq), np.uint8) if isinstance(seq, bytes) else seq
    return jnp.asarray(
        spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(seq)).reshape(-1)
    )


def _naive5(seq: bytes, query: bytes) -> np.ndarray:
    """Match positions in the normalized seq; N literal, ? wildcard."""
    s = seq.upper().replace(b"U", b"T")
    q = query.upper().replace(b"U", b"T")
    out = []
    for i in range(len(s) - len(q) + 1):
        if all(qc in (ord("?"), sc) for sc, qc in zip(s[i:], q)):
            out.append(i)
    return np.asarray(out, dtype=np.int64)


def test_compile_query_b5_phases():
    qc = search.compile_query_b5(b"AC?N")
    assert len(qc) == 3
    # phase 0: digits A=0,C=1,?,N=4 over triplets (0,1,?) (4,-,-)
    q8, care8 = qc[0]
    assert list(q8) == [0 | 1 << 3, 4]
    assert list(care8) == [0o077, 0o007]
    # phase 2: slots shift by 2 -> triplets (-,-,0) (1,?,4)
    q8, care8 = qc[2]
    assert list(q8) == [0 << 6, 1 | 4 << 6]
    assert list(care8) == [0o700, 0o707]


def test_compile_query_b5_rejects_junk():
    with pytest.raises(ValueError):
        search.compile_query_b5(b"ACGX")
    with pytest.raises(ValueError):
        search.compile_query_b5(b"")


@pytest.mark.parametrize(
    "query", [b"ACG", b"acgu", b"A??T", b"GATTACA", b"NNC", b"TAN?GA"]
)
def test_match_mask_b5_basic(rng, query):
    seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=301))
    got = np.flatnonzero(
        np.asarray(search.match_mask_b5(_enc5(seq), len(seq), query))
    )
    assert np.array_equal(got, _naive5(seq, query))


def test_match_b5_fuzz(rng):
    """Planted + random occurrences at every phase and near both ends."""
    for trial in range(8):
        L = int(rng.integers(30, 200))
        seq = bytearray(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L))
        qlen = int(rng.integers(1, 12))
        query = bytes(rng.choice(np.frombuffer(b"ACGTN?", np.uint8), size=qlen))
        concrete = bytes(b if b != ord("?") else ord("A") for b in query)
        for p in (0, 1, 2, L - qlen):  # all phases + the last valid start
            if 0 <= p <= L - qlen:
                seq[p : p + qlen] = concrete
        got = np.flatnonzero(
            np.asarray(search.match_mask_b5(_enc5(bytes(seq)), L, query))
        )
        want = _naive5(bytes(seq), query)
        assert np.array_equal(got, want), (trial, query, bytes(seq))
        cnt = int(search.match_count_b5(_enc5(bytes(seq)), L, query))
        assert cnt == want.size
        assert np.array_equal(
            search.match_positions_b5(_enc5(bytes(seq)), L, query), want
        )


def test_match_b5_n_is_literal(rng):
    """N in a base-5 query matches only stream N — unlike the 2-bit tier."""
    seq = b"ACGNNACG"
    got = search.match_positions_b5(_enc5(seq), len(seq), b"NN")
    assert got.tolist() == [3]
    got_w = search.match_positions_b5(_enc5(seq), len(seq), b"??")
    assert got_w.tolist() == list(range(7))


def test_match_b5_errors():
    w = _enc5(b"ACGTN" * 4)
    with pytest.raises(ValueError, match="shorter than query"):
        search.match_mask_b5(w, 3, b"ACGTN")
    with pytest.raises(ValueError, match="capacity"):
        search.match_mask_b5(w, 2000, b"ACG")
    with pytest.raises(TypeError, match="interleaved"):
        search.match_mask_b5(w.reshape(2, -1), 20, b"ACG")


@pytest.mark.parametrize("codec", ["2bit", "base5"])
def test_match_batch_ragged(rng, codec):
    """Batched per-read masks == per-read single-stream scans over true
    lengths; padding tails never match."""
    B, L = 6, 64 if codec == "2bit" else 54
    alpha = b"ACGT" if codec == "2bit" else b"ACGTN"
    query = b"GAT?ACA" if codec == "base5" else b"GANTACA"
    reads = rng.choice(np.frombuffer(alpha, np.uint8), size=(B, L))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[0], lengths[1] = 0, L
    enc = oracle.n_to_bits_lut if codec == "2bit" else oracle.n_to_bits2_lut
    naive = _naive if codec == "2bit" else _naive5
    rows = []
    for b in range(B):
        reads[b, lengths[b]:] = ord("A")
        # plant one hit inside the valid region when it fits
        concrete = query.replace(b"?", b"C").replace(b"N", b"C")
        if lengths[b] > len(query) + 2:
            reads[b, 1 : 1 + len(query)] = np.frombuffer(concrete, np.uint8)
        rows.append(spec.u64_to_u32_pairs(enc(reads[b])).reshape(-1))
    words = jnp.asarray(np.stack(rows))
    fn = search.match_mask_batch if codec == "2bit" else search.match_mask_b5_batch
    mask = np.asarray(fn(words, jnp.asarray(lengths), query))
    counts = np.asarray(
        search.match_counts_batch(words, jnp.asarray(lengths), query, codec=codec)
    )
    for b in range(B):
        want = naive(bytes(reads[b][: lengths[b]]), query)
        assert np.array_equal(np.flatnonzero(mask[b]), want), (codec, b)
        assert counts[b] == want.size


def test_match_counts_sharded(rng):
    """parallel.match_counts over the 8-device mesh == batched counts."""
    from cute_nucleotides_jax import parallel

    B, L = 16, 64
    query = b"GATTACA"
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    reads[3, 10:17] = np.frombuffer(query, np.uint8)
    lengths = np.full(B, L, np.int32)
    lengths[5] = 20
    words = jnp.asarray(np.stack([
        spec.u64_to_u32_pairs(oracle.n_to_bits_lut(reads[b])).reshape(-1)
        for b in range(B)
    ]))
    got = np.asarray(
        parallel.match_counts(words, jnp.asarray(lengths), query)
    )
    want = np.asarray(
        search.match_counts_batch(words, jnp.asarray(lengths), query)
    )
    assert got.shape == (B,)
    assert np.array_equal(got, want)
    assert got[3] >= 1


def test_match_bits_b5_matches_mask(rng):
    """The base-5 packed-bitmask scan agrees with the mask across row
    seams, phases, wildcards, and ragged tails."""
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    for L, query in (
        (13824 + 311, b"GATTACA"),       # row seam + ragged tail
        (13824, b"TAN?GA"),              # exactly one bitmask row
        (27 * 80, b"A"),                 # sub-row stream, 1-nt query
        (30000, b"??C??"),               # wildcards across phases
        (14000, b"ACGTN" * 9),           # 45-nt query, multi-triplet fold
    ):
        seq = np.asarray(rng.choice(alpha, L))
        planted = np.frombuffer(query.replace(b"?", b"A"), np.uint8)
        for p in (0, 1, 2, 27, 13824 - len(query), L - len(query)):
            if 0 <= p <= L - len(query):
                seq[p : p + len(query)] = planted
        w = _enc5(bytes(seq))
        mask = np.asarray(search.match_mask_b5(w, L, query))
        bits = np.asarray(search.match_bits_b5(w, L, query))
        got = np.zeros(mask.size, bool)
        W = bits.shape[1]
        for ri, wi in zip(*np.nonzero(bits)):
            b = int(bits[ri, wi])
            base = 27 * (ri * W + wi)
            for s in range(27):
                if (b >> s) & 1:
                    assert base + s < got.size, (L, query, base + s)
                    got[base + s] = True
        assert np.array_equal(got, mask), (L, query)


def test_match_bits_prefilter_fuzz(rng):
    """Randomized long-query fuzz of the r05 anchor prefilter (2-bit
    kernel tier vs the XLA mask tier): random lengths across the
    single/multi-word and prefilter boundaries, random N-wildcards,
    planted hits (so the pl.when verify branch runs), and a
    high-duplication stream (dense anchor candidates)."""
    alpha2 = np.frombuffer(b"ACGT", np.uint8)
    for trial in range(6):
        L = int(rng.integers(4000, 30000))
        dense = trial == 5
        seq = np.asarray(
            rng.choice(alpha2[:2] if dense else alpha2, L)
        )
        m = int(rng.integers(2, 200))
        q = bytearray(rng.choice(alpha2, m).tobytes())
        for i in sorted(rng.choice(m, size=min(m // 5, 8), replace=False)):
            q[i] = ord("N")
        q = bytes(q)
        planted = np.frombuffer(q.replace(b"N", b"C"), np.uint8)
        for p in (0, int(rng.integers(0, max(L - m, 1))), L - m):
            if 0 <= p <= L - m:
                seq[p : p + m] = planted
        w = _enc(bytes(seq))
        want = np.flatnonzero(np.asarray(search.match_mask(w, L, q)))
        got = search.match_positions(w, L, q)
        assert np.array_equal(got, want), (trial, L, m)
        assert want.size >= 1  # the planted hit exercised the branch


def test_match_b5_routing_parity(rng):
    """count/positions agree with the mask and the packed bitmask on
    short and long streams (the sizes either side of a former kernel
    routing threshold)."""
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    query = b"GAT?ACA"
    for L in (27 * 18, 27 * 600):  # 972 nt (36 words) / 16200 nt (1200 u32)
        seq = np.asarray(rng.choice(alpha, L))
        seq[5 : 5 + 7] = np.frombuffer(b"GATAACA", np.uint8)
        w = _enc5(bytes(seq))
        want = np.flatnonzero(np.asarray(search.match_mask_b5(w, L, query)))
        assert np.array_equal(search.match_positions_b5(w, L, query), want)
        assert int(search.match_count_b5(w, L, query)) == want.size
        bits = np.asarray(search.match_bits_b5(w, L, query))
        assert int(np.sum([bin(int(v)).count("1") for v in bits.reshape(-1)])) == want.size


def test_match_bits_b5_errors():
    w = _enc5(b"ACGTN" * 600)
    with pytest.raises(ValueError, match="shorter than query"):
        search.match_bits_b5(w, 3000, b"A" * 3001)
    with pytest.raises(ValueError, match="shorter than query"):
        search.match_bits_b5(w, 3, b"ACGTN")
    with pytest.raises(TypeError, match="interleaved"):
        search.match_bits_b5(w.reshape(2, -1), 20, b"ACG")


def test_match_errors():
    w = _enc(b"ACGTACGT")
    with pytest.raises(ValueError):
        search.match_mask(w, 8, b"ACGTACGTT")  # query longer than stream
    with pytest.raises(ValueError):
        search.match_bits(w, 999, b"ACG")  # length exceeds capacity
    with pytest.raises(TypeError):
        search.match_mask(jnp.zeros((2, 2), jnp.uint32), 8, b"ACG")
