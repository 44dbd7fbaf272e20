"""Compositional fuzz: random programs over the packed-domain op algebra.

The beyond-reference ops (slice / concat / revcomp, both codecs) are each
oracle-tested in isolation; this fuzz chains them into random PROGRAMS and
asserts the packed stream still decodes to the byte-domain result of the
same program — the composition contract real pipelines rely on (e.g.
revcomp(concat(slice(a), slice(b))) without ever leaving the packed
domain).  Lengths are drawn from a small bucket set so the jit cache stays
bounded on the CPU suite.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from cute_nucleotides_jax.ops import oracle, seqops, spec  # noqa: E402

LENS = (5, 27, 32, 59, 128)  # bucket set bounds the per-shape jit compiles
STEPS = 4
PROGRAMS = 12


def _case(codec):
    if codec == "2bit":
        return dict(
            alpha=b"ACGT",
            enc=lambda s: spec.u64_to_u32_pairs(
                oracle.n_to_bits_lut(np.frombuffer(s, np.uint8))
            ).reshape(-1),
            dec=lambda w, n: bytes(
                oracle.bits_to_n_lut(spec.u32_pairs_to_u64(np.asarray(w).reshape(-1, 2)).reshape(-1), n)
            ),
            rc=seqops.revcomp_packed,
            sl=seqops.packed_slice,
            cc=seqops.packed_concat,
            comp=bytes.maketrans(b"ACGT", b"TGCA"),
        )
    return dict(
        alpha=b"ACGTN",
        enc=lambda s: spec.u64_to_u32_pairs(
            oracle.n_to_bits2_lut(np.frombuffer(s, np.uint8))
        ).reshape(-1),
        dec=lambda w, n: bytes(
            oracle.bits_to_n2_lut(spec.u32_pairs_to_u64(np.asarray(w).reshape(-1, 2)).reshape(-1), n)
        ),
        rc=seqops.revcomp_packed_b5,
        sl=seqops.packed_slice_b5,
        cc=seqops.packed_concat_b5,
        comp=bytes.maketrans(b"ACGTN", b"TGCAN"),
    )


@pytest.mark.parametrize("codec", ["2bit", "base5"])
def test_random_op_programs_match_byte_oracle(codec):
    c = _case(codec)
    rng = np.random.default_rng(0xF0552 if codec == "2bit" else 0xF0555)

    for prog in range(PROGRAMS):
        n = int(rng.choice(LENS))
        seq = bytes(rng.choice(np.frombuffer(c["alpha"], np.uint8), n))
        words = jnp.asarray(c["enc"](seq))
        for step in range(STEPS):
            op = rng.integers(0, 3)
            if op == 0 and n > 0:  # slice to a bucketed length
                m = int(min(rng.choice(LENS), n))
                start = int(rng.integers(0, n - m + 1))
                words = c["sl"](words, start, m)
                seq, n = seq[start : start + m], m
            elif op == 1:  # revcomp in place
                words = c["rc"](words, n)
                seq = seq.translate(c["comp"])[::-1]
            else:  # concat with a fresh bucketed tail
                m = int(rng.choice(LENS))
                tail = bytes(
                    rng.choice(np.frombuffer(c["alpha"], np.uint8), m)
                )
                words = c["cc"](words, n, jnp.asarray(c["enc"](tail)), m)
                seq, n = seq + tail, n + m
            assert c["dec"](words, n) == seq, (
                codec, prog, step, op, n
            )
            if codec == "base5":
                # every composition of packed-domain ops must preserve
                # stream integrity: the checked decode stays clean
                from cute_nucleotides_jax.models import Base5Codec

                dec_b, bad = Base5Codec().decode_checked(words)
                assert not bool(bad), (prog, step, op, n)
                assert bytes(np.asarray(dec_b)[:n]) == seq


def test_align_metric_properties():
    """Edit distance property fuzz: metric axioms + op-algebra invariants.

    The DP oracles pin exact values elsewhere; these assert the properties
    real pipelines rely on across random inputs: symmetry, identity,
    triangle inequality, the k-mutation upper bound, and revcomp
    invariance (d(a, b) == d(revcomp(a), revcomp(b)) — alignment is
    reversal- and complement-invariant under unit costs).
    """
    from cute_nucleotides_jax.ops import align

    rng = np.random.default_rng(0xFADE)

    def pack_batch(seqs):
        lens = np.array([len(s) for s in seqs], np.int32)
        W = 2 * max(1, -(-int(lens.max()) // 32))
        rows = np.zeros((len(seqs), W), np.uint32)
        for i, s in enumerate(seqs):
            if s:
                v = spec.u64_to_u32_pairs(
                    oracle.n_to_bits_lut(np.frombuffer(s, np.uint8))
                ).reshape(-1)
                rows[i, : v.size] = v
        return rows, lens

    def dist(xs, ys):
        qw, ql = pack_batch(xs)
        tw, tl = pack_batch(ys)
        return np.asarray(align.edit_distance_packed(qw, ql, tw, tl))

    def rand(n):
        return bytes(rng.choice(list(b"ACGT"), size=n).astype(np.uint8))

    def revcomp(s):
        return s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))

    a = [rand(int(rng.integers(1, 70))) for _ in range(8)]
    b = [rand(int(rng.integers(1, 70))) for _ in range(8)]
    c = [rand(int(rng.integers(1, 70))) for _ in range(8)]

    d_ab, d_ba = dist(a, b), dist(b, a)
    np.testing.assert_array_equal(d_ab, d_ba)  # symmetry
    assert (dist(a, a) == 0).all()  # identity
    d_ac, d_cb = dist(a, c), dist(c, b)
    assert (d_ab <= d_ac + d_cb).all()  # triangle inequality
    # k point mutations bound the distance by k
    mut = []
    ks = []
    for s in a:
        s = bytearray(s)
        k = int(rng.integers(0, min(4, len(s)) + 1))
        for pos in rng.choice(len(s), size=k, replace=False):
            s[pos] = rng.choice([x for x in b"ACGT" if x != s[pos]])
        mut.append(bytes(s))
        ks.append(k)
    assert (dist(a, mut) <= np.array(ks)).all()
    # revcomp invariance
    np.testing.assert_array_equal(
        d_ab, dist([revcomp(s) for s in a], [revcomp(s) for s in b])
    )


def test_align_metric_properties_b5():
    """Base-5 mirror of the metric fuzz (5-symbol alphabet, N literal)."""
    from cute_nucleotides_jax.ops import align

    rng = np.random.default_rng(0xB5FA)

    def pack_batch(seqs):
        lens = np.array([len(s) for s in seqs], np.int32)
        W = 2 * max(1, -(-int(lens.max()) // 27))
        rows = np.zeros((len(seqs), W), np.uint32)
        for i, s in enumerate(seqs):
            if s:
                v = spec.u64_to_u32_pairs(
                    oracle.n_to_bits2_lut(np.frombuffer(s, np.uint8))
                ).reshape(-1)
                rows[i, : v.size] = v
        return rows, lens

    def dist(xs, ys):
        qw, ql = pack_batch(xs)
        tw, tl = pack_batch(ys)
        return np.asarray(align.edit_distance_packed_b5(qw, ql, tw, tl))

    def rand(n):
        return bytes(rng.choice(list(b"ACGTN"), size=n).astype(np.uint8))

    a = [rand(int(rng.integers(1, 60))) for _ in range(6)]
    b = [rand(int(rng.integers(1, 60))) for _ in range(6)]
    c = [rand(int(rng.integers(1, 60))) for _ in range(6)]
    d_ab = dist(a, b)
    np.testing.assert_array_equal(d_ab, dist(b, a))  # symmetry (N literal)
    assert (dist(a, a) == 0).all()  # identity: N matches N
    assert (d_ab <= dist(a, c) + dist(c, b)).all()  # triangle inequality


def test_align_composes_with_packed_slice(rng):
    """d(q, slice(t, a, n)) computed on device-sliced packed words equals
    the byte-domain DP on the same substring — alignment composes with the
    region ops without a decode round-trip."""
    from cute_nucleotides_jax.ops import align, seqops

    t = bytes(
        rng.choice(list(b"ACGT"), size=300).astype(np.uint8)
    )
    tw = jnp.asarray(
        spec.u64_to_u32_pairs(
            oracle.n_to_bits_lut(np.frombuffer(t, np.uint8))
        ).reshape(-1)
    )
    for _ in range(6):
        a = int(rng.integers(0, 200))
        n = int(rng.integers(1, 90))
        q = bytes(rng.choice(list(b"ACGT"), size=17).astype(np.uint8))
        sub_w = np.asarray(seqops.packed_slice(tw, a, n))
        qw = spec.u64_to_u32_pairs(oracle.n_to_bits_lut(q)).reshape(-1)
        W = max(len(sub_w), 2)
        d = int(
            align.edit_distance_packed(
                np.pad(qw, (0, max(0, 2 - len(qw))))[None, :],
                np.array([len(q)], np.int32),
                np.pad(sub_w, (0, W - len(sub_w)))[None, :],
                np.array([n], np.int32),
            )[0]
        )
        assert d == align.edit_distance_reference(q, t[a : a + n]), (a, n)
