"""Multi-device semantics on the virtual 8-device CPU mesh (SURVEY.md §4d):
data-parallel sharding, all_gather merge, and bit-exact block-sharded
long-sequence encode/decode."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cute_nucleotides_jax.ops import oracle, spec
from cute_nucleotides_jax import parallel
from cute_nucleotides_jax.parallel import longseq, mesh as mesh_lib

ALPHABET = np.frombuffer(b"ACGTUacgtu", dtype=np.uint8)
ALPHABET_N = np.frombuffer(b"ACGTUNacgtun", dtype=np.uint8)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    m = parallel.make_mesh()
    assert m.shape[mesh_lib.DATA_AXIS] == 8 and m.shape[mesh_lib.SEQ_AXIS] == 1
    m2 = parallel.make_mesh(seq=4)
    assert m2.shape[mesh_lib.DATA_AXIS] == 2 and m2.shape[mesh_lib.SEQ_AXIS] == 4


@pytest.mark.parametrize("gather", [False, True])
def test_data_parallel_encode_matches_oracle(rng, gather):
    B, L = 16, 96
    batch = rng.choice(ALPHABET, size=(B, L))
    out = np.asarray(
        parallel.data_parallel_encode(jnp.asarray(batch), gather=gather)
    )
    assert out.shape == (B, L // 16)
    for b in range(B):
        assert np.array_equal(
            spec.u32_pairs_to_u64(out[b]), oracle.n_to_bits_lut(batch[b])
        )


def test_data_parallel_encode_mxu_variant(rng):
    """Every 2-bit encode variant routes through the data-parallel path
    ("dot", the pext slot, here); an unknown tier is refused."""
    B = 16
    batch = rng.choice(ALPHABET, size=(B, 2048))
    with pytest.raises(ValueError, match="unknown device tier"):
        parallel.data_parallel_encode(jnp.asarray(batch), tier="pallas", variant="mul")
    out = np.asarray(
        parallel.data_parallel_encode(jnp.asarray(batch), tier="xla", variant="dot")
    )
    assert out.shape == (B, 2048 // 16)
    for b in range(B):
        assert np.array_equal(
            spec.u32_pairs_to_u64(out[b]), oracle.n_to_bits_lut(batch[b])
        )


def test_kmer_spectrum_sharded_matches_single_device(rng):
    """psum-merged spectrum over the 8-device mesh == the batched histogram
    on one device, with ragged per-read lengths."""
    from cute_nucleotides_jax.ops import kmer

    B, L, k = 16, 96, 6
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    for b in range(B):
        reads[b, lengths[b]:] = ord("A")
    words = jnp.asarray(
        np.stack([
            spec.u64_to_u32_pairs(oracle.n_to_bits_lut(reads[b])).reshape(-1)
            for b in range(B)
        ])
    )
    got = np.asarray(
        parallel.kmer_spectrum(words, jnp.asarray(lengths), k)
    )
    want = np.asarray(kmer.kmer_histogram_batch(words, jnp.asarray(lengths), k))
    assert got.shape == (4**k,)
    assert int(got.sum()) == int(np.maximum(lengths - k + 1, 0).sum())
    assert np.array_equal(got, want)
    # canonical variant also merges correctly
    got_c = np.asarray(
        parallel.kmer_spectrum(words, jnp.asarray(lengths), k, canonical=True)
    )
    want_c = np.asarray(
        kmer.kmer_histogram_batch(words, jnp.asarray(lengths), k, canonical=True)
    )
    assert np.array_equal(got_c, want_c)


def test_data_parallel_decode_roundtrip(rng):
    B, L = 8, 64
    batch = rng.choice(ALPHABET, size=(B, L))
    words = parallel.data_parallel_encode(jnp.asarray(batch))
    back = np.asarray(parallel.data_parallel_decode(words))
    want = np.frombuffer(
        batch.tobytes().upper().replace(b"U", b"T"), dtype=np.uint8
    ).reshape(B, L)
    assert np.array_equal(back, want)


def test_data_parallel_b5(rng):
    B, L = 8, 108
    batch = rng.choice(ALPHABET_N, size=(B, L))
    out = np.asarray(
        parallel.data_parallel_encode(jnp.asarray(batch), codec="base5")
    )
    for b in range(B):
        assert np.array_equal(
            spec.u32_pairs_to_u64(out[b]), oracle.n_to_bits2_lut(batch[b])
        )


def test_sharded_codec_object(rng):
    sc = parallel.ShardedCodec()
    B, L = 16, 32
    batch = rng.choice(ALPHABET, size=(B, L))
    x = sc.shard(batch)
    words = sc.encode(x)
    back = np.asarray(sc.decode(words, gather=True))
    want = np.frombuffer(
        batch.tobytes().upper().replace(b"U", b"T"), dtype=np.uint8
    ).reshape(B, L)
    assert np.array_equal(back, want)


# --- block-sharded long-sequence mode ---------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 1000, 40000, 40001])
def test_long_2bit_bit_exact(rng, n):
    s = rng.choice(ALPHABET, size=n)
    got = longseq.encode_long_2bit(s)
    assert np.array_equal(got, oracle.n_to_bits_lut(s))


@pytest.mark.parametrize("n", [1, 26, 27, 1000, 40000, 40013])
def test_long_b5_bit_exact(rng, n):
    s = rng.choice(ALPHABET_N, size=n)
    got = longseq.encode_long_b5(s)
    assert np.array_equal(got, oracle.n_to_bits2_lut(s))


def test_long_decode_roundtrip(rng):
    n = 12345
    s = rng.choice(ALPHABET, size=n)
    bits = oracle.n_to_bits_lut(s)
    got = longseq.decode_long_2bit(bits, n)
    want = oracle.bits_to_n_lut(bits, n)
    assert np.array_equal(got, want)

    s5 = rng.choice(ALPHABET_N, size=n)
    bits5 = oracle.n_to_bits2_lut(s5)
    assert np.array_equal(
        longseq.decode_long_b5(bits5, n), oracle.bits_to_n2_lut(bits5, n)
    )


def test_shard_points_alignment():
    pts = longseq.shard_points_2bit(40000, 8)
    assert pts[0] == 0 and pts[-1] == 40000
    assert all(p % 32 == 0 for p in pts[1:-1])
    pts5 = longseq.shard_points_b5(40000, 8)
    assert all(p % 27 == 0 for p in pts5[1:-1])


def test_data_parallel_pallas_tier(rng):
    """The production config ("auto" tier inside shard_map) composes and
    round-trips bit-exactly."""
    B, L = 8, 64
    batch = rng.choice(ALPHABET, size=(B, L))
    out = np.asarray(
        parallel.data_parallel_encode(jnp.asarray(batch), tier="auto")
    )
    for b in range(B):
        assert np.array_equal(
            spec.u32_pairs_to_u64(out[b]), oracle.n_to_bits_lut(batch[b])
        )
    back = np.asarray(
        parallel.data_parallel_decode(jnp.asarray(out), tier="auto")
    )
    want = np.frombuffer(
        batch.tobytes().upper().replace(b"U", b"T"), dtype=np.uint8
    ).reshape(B, L)
    assert np.array_equal(back, want)


def test_checked_encode_in_shard_map(rng):
    """The checked encode composes with data-parallel shard_map:
    per-shard flags reduce to a global any() via psum."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from cute_nucleotides_jax.ops import xla

    B, L = 16, 512
    batch = rng.choice(ALPHABET, size=(B, L))
    batch[5, 100] = ord("X")
    m = parallel.make_mesh()

    def shard_fn(x):
        words, bad = xla.encode_2bit_words_checked(x, "mul")
        return words, jax.lax.psum(
            bad.any().astype(jnp.int32), mesh_lib.DATA_AXIS
        )

    fn = shard_map(
        shard_fn,
        mesh=m,
        in_specs=P(mesh_lib.DATA_AXIS, None),
        out_specs=(P(mesh_lib.DATA_AXIS, None), P()),
        check_vma=False,
    )
    words, nbad = jax.jit(fn)(jnp.asarray(batch))
    assert int(nbad) == 1
    for b in range(B):
        assert np.array_equal(
            spec.u32_pairs_to_u64(np.asarray(words[b])),
            oracle.n_to_bits_lut(
                np.where(batch[b] == ord("X"), ord("A"), batch[b])
            )
            if b == 5
            else oracle.n_to_bits_lut(batch[b]),
        )


def test_match_long_sharded_boundaries(rng):
    """Sharded pattern scan == single-device scan, incl. hits that straddle
    the shard-boundary halo exchange."""
    from cute_nucleotides_jax.ops import search, spec

    L = 50_000
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    # plant GATTACA straddling each 8-way shard boundary of the word split
    W = spec.num_words_2bit(L) * 2  # u32 words
    w_eq = -(-W // 8)
    q = b"GATTACA"
    planted = []
    for k in range(1, 8):
        p = 16 * (k * w_eq) - 3  # spans the boundary between shards k-1, k
        s[p : p + len(q)] = np.frombuffer(q, np.uint8)
        planted.append(p)
    bits = oracle.n_to_bits_lut(s)
    got = longseq.match_long(bits, L, q)
    w32 = jnp.asarray(spec.u64_to_u32_pairs(bits).reshape(-1))
    want = search.match_positions(w32, L, q)
    assert np.array_equal(got, want)
    assert set(planted) <= set(got.tolist())
    # wildcard + explicit mesh + tail position (start = n-1)
    s2 = np.full(1000, ord("C"), np.uint8)
    s2[-3:] = [ord("A"), ord("G"), ord("A")]
    bits2 = oracle.n_to_bits_lut(s2)
    m = parallel.make_mesh(data=1, seq=8)
    got2 = longseq.match_long(bits2, 1000, b"ANA", mesh=m)
    assert np.array_equal(got2, [997])


def test_match_long_b5_sharded(rng):
    """Base-5 sharded exact search == single-stream scan, with hits planted
    across every 8-way shard boundary (27-nt words never align to 2^k)."""
    from cute_nucleotides_jax.ops import search, spec

    L = 54_000
    s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L)
    Wd = spec.num_words_b5(L)  # u64 words
    weq = -(-Wd // 8)
    q = b"GAT?ACN"
    planted = []
    for k in range(1, 8):
        p = 27 * (k * weq) - 3  # spans the boundary between shards k-1, k
        if p + len(q) <= L:
            s[p : p + len(q)] = np.frombuffer(b"GATCACN", np.uint8)
            planted.append(p)
    bits = oracle.n_to_bits2_lut(s)
    got = longseq.match_long_b5(bits, L, q)
    w32 = jnp.asarray(spec.u64_to_u32_pairs(bits.reshape(1, -1)).reshape(-1))
    want = search.match_positions_b5(w32, L, q)
    assert np.array_equal(got, want)
    assert set(planted) <= set(got.tolist())
    # literal-N + explicit mesh + tail position (start = n-1)
    s2 = np.full(1000, ord("C"), np.uint8)
    s2[-3:] = [ord("A"), ord("N"), ord("A")]
    bits2 = oracle.n_to_bits2_lut(s2)
    m = parallel.make_mesh(data=1, seq=8)
    got2 = longseq.match_long_b5(bits2, 1000, b"ANA", mesh=m)
    assert np.array_equal(got2, [997])
    # a long query (1025 nt, past any fixed row overlap) straddling a
    # shard boundary is still found exactly once, through the halo
    p = 27 * (3 * weq) - 500
    long_q = bytes(s[p : p + 1025])
    got3 = longseq.match_long_b5(bits, L, long_q)
    assert p in got3.tolist()
    assert np.array_equal(got3, search.match_positions_b5(w32, L, long_q))


def test_best_match_long_sharded(rng):
    """Sharded approximate search == DP oracle, incl. a one-error hit that
    straddles the shard-boundary halo exchange."""
    from cute_nucleotides_jax.ops import align, spec

    L = 20_000
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    q = b"GATTACAGATTACAGATTACA"
    W = spec.num_words_2bit(L) * 2
    w_eq = -(-W // 8)
    mut = bytearray(q)
    mut[10] = ord("C")  # T -> C: one substitution
    p = 16 * (3 * w_eq) - 5  # straddles the shard-2/3 boundary
    s[p : p + len(q)] = np.frombuffer(bytes(mut), np.uint8)
    bits = oracle.n_to_bits_lut(s)
    got = longseq.best_match_long(bits, L, q)
    want = align.best_match_reference(q, bytes(s))
    assert got == want
    assert got[0] == 1 and got[1] == p + len(q)
    # trivial case on an explicit mesh: nothing beats the empty alignment
    m = mesh_lib.make_mesh(data=1, seq=4, devices=jax.devices()[:4])
    s2 = np.full(1000, ord("C"), np.uint8)
    assert longseq.best_match_long(
        oracle.n_to_bits_lut(s2), 1000, b"AAAAA", mesh=m
    ) == (5, 0)


def test_edit_distances_data_parallel(rng):
    """Sharded batched edit distance == single-device op, both codecs."""
    from cute_nucleotides_jax.ops import align

    B, m, n = 16, 40, 70
    qs = [rng.choice(np.frombuffer(b"ACGT", np.uint8), size=m) for _ in range(B)]
    ts = [rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n) for _ in range(B)]

    def rows(seqs, enc):
        out = [spec.u64_to_u32_pairs(enc(s)).reshape(-1) for s in seqs]
        return np.stack(out)

    qw = rows(qs, oracle.n_to_bits_lut)
    tw = rows([t.copy() for t in ts], oracle.n_to_bits_lut)
    got = np.asarray(parallel.edit_distances(qw, m, tw, n))
    want = np.asarray(
        align.edit_distance_packed(
            qw, np.full(B, m, np.int32), tw, np.full(B, n, np.int32)
        )
    )
    assert np.array_equal(got, want)
    qw5 = rows(qs, oracle.n_to_bits2_lut)
    tw5 = rows([t.copy() for t in ts], oracle.n_to_bits2_lut)
    got5 = np.asarray(
        parallel.edit_distances(qw5, m, tw5, n, codec="base5")
    )
    want5 = [
        align.edit_distance_reference_b5(bytes(q), bytes(t))
        for q, t in zip(qs, ts)
    ]
    assert np.array_equal(got5, want5)


def test_best_match_long_b5_sharded(rng):
    """Base-5 sharded approximate search == digit-DP oracle, boundary hit."""
    from cute_nucleotides_jax.ops import align, spec

    L = 27 * 500  # 13500 nt
    s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L)
    q = b"GATTACANGATTACANGATTA"
    Wp = spec.num_words_b5(L)  # u64 words == u32 pairs
    p_eq = -(-Wp // 8)
    mut = bytearray(q)
    mut[2] = ord("C")  # T -> C
    p = 27 * (3 * p_eq) - 5  # straddles the shard-2/3 pair boundary
    s[p : p + len(q)] = np.frombuffer(bytes(mut), np.uint8)
    bits = oracle.n_to_bits2_lut(s)
    got = longseq.best_match_long_b5(bits, L, q)
    want = align.best_match_reference_b5(q, bytes(s))
    assert got == want
    assert got[0] == 1 and got[1] == p + len(q)
    # wildcard query + trivial case on an explicit mesh
    m = mesh_lib.make_mesh(data=1, seq=4, devices=jax.devices()[:4])
    s2 = np.full(1000, ord("C"), np.uint8)
    assert longseq.best_match_long_b5(
        oracle.n_to_bits2_lut(s2), 1000, b"NNNNN", mesh=m
    ) == (5, 0)
    assert longseq.best_match_long_b5(
        oracle.n_to_bits2_lut(s2), 1000, b"??C??", mesh=m
    ) == (0, 5)  # ? matches any digit, so the C run is an exact hit
