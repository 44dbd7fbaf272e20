"""Myers bit-parallel edit distance vs the DP oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from cute_nucleotides_jax.ops import align, oracle, spec

ALPHA = b"ACGT"


def _pack_batch(seqs):
    """ASCII seqs -> (words u32[B, W], lens i32[B]) ('A'-padded rows)."""
    lens = np.array([len(s) for s in seqs], np.int32)
    wmax = 2 * max(1, -(-int(lens.max()) // 32))
    words = np.zeros((len(seqs), wmax), np.uint32)
    for i, s in enumerate(seqs):
        if len(s):
            w = spec.u64_to_u32_pairs(oracle.n_to_bits_lut(s)).reshape(-1)
            words[i, : len(w)] = w
    return words, lens


def _rand_seq(rng, n):
    return bytes(rng.choice(list(ALPHA), size=n).astype(np.uint8))


class TestPeq:
    def test_bits_match_codes(self, rng):
        s = _rand_seq(rng, 77)
        words, lens = _pack_batch([s])
        peq = np.asarray(align.peq_from_packed(words, lens))[0]
        for i, b in enumerate(s):
            code = (b >> 1) & 3
            for c in range(4):
                bit = (peq[c, i // 32] >> (i % 32)) & 1
                assert bit == (1 if c == code else 0), (i, c)

    def test_padding_masked(self, rng):
        s = b"CGT" * 5  # no A: every A-plane bit must be 0, incl. padding
        words, lens = _pack_batch([s])
        peq = np.asarray(align.peq_from_packed(words, lens))[0]
        assert peq[0].sum() == 0
        # all planes zero at and beyond qlen
        for c in range(4):
            for i in range(len(s), 32 * peq.shape[1]):
                assert (peq[c, i // 32] >> (i % 32)) & 1 == 0


class TestGlobal:
    @pytest.mark.parametrize("m,n", [(7, 9), (32, 32), (33, 40), (96, 200)])
    def test_random_vs_dp(self, rng, m, n):
        B = 16
        qs = [_rand_seq(rng, int(rng.integers(0, m + 1))) for _ in range(B)]
        ts = [_rand_seq(rng, int(rng.integers(0, n + 1))) for _ in range(B)]
        qw, ql = _pack_batch(qs)
        tw, tl = _pack_batch(ts)
        got = np.asarray(align.edit_distance_packed(qw, ql, tw, tl))
        want = [align.edit_distance_reference(q, t) for q, t in zip(qs, ts)]
        np.testing.assert_array_equal(got, want)

    def test_identical_and_disjoint(self, rng):
        s = _rand_seq(rng, 50)
        qw, ql = _pack_batch([s, b"A" * 20])
        tw, tl = _pack_batch([s, b"C" * 20])
        got = np.asarray(align.edit_distance_packed(qw, ql, tw, tl))
        np.testing.assert_array_equal(got, [0, 20])

    def test_case_and_u_fold(self):
        qw, ql = _pack_batch([b"ACGT"])
        tw, tl = _pack_batch([b"acgu"])
        assert int(align.edit_distance_packed(qw, ql, tw, tl)[0]) == 0

    def test_block_boundaries(self, rng):
        # m exactly at 32/64 and one off either side: carry/shift seams
        for m in (31, 32, 33, 63, 64, 65):
            q = _rand_seq(rng, m)
            t = _rand_seq(rng, m + 5)
            qw, ql = _pack_batch([q])
            tw, tl = _pack_batch([t])
            got = int(align.edit_distance_packed(qw, ql, tw, tl)[0])
            assert got == align.edit_distance_reference(q, t), m

    def test_known_small(self):
        # ACGT -> AGT: one deletion; ACGT -> ACCT: one substitution
        qw, ql = _pack_batch([b"ACGT", b"ACGT"])
        tw, tl = _pack_batch([b"AGT", b"ACCT"])
        got = np.asarray(align.edit_distance_packed(qw, ql, tw, tl))
        np.testing.assert_array_equal(got, [1, 1])

    def test_empty_rows(self):
        qw, ql = _pack_batch([b"", b"ACG", b""])
        tw, tl = _pack_batch([b"ACGT", b"", b""])
        got = np.asarray(align.edit_distance_packed(qw, ql, tw, tl))
        np.testing.assert_array_equal(got, [4, 3, 0])


class TestSemiglobal:
    @pytest.mark.parametrize("m,n", [(5, 60), (32, 64), (40, 120)])
    def test_random_vs_dp(self, rng, m, n):
        B = 12
        qs = [_rand_seq(rng, int(rng.integers(1, m + 1))) for _ in range(B)]
        ts = [_rand_seq(rng, int(rng.integers(0, n + 1))) for _ in range(B)]
        qw, ql = _pack_batch(qs)
        tw, tl = _pack_batch(ts)
        gd, ge = (
            np.asarray(x) for x in align.best_match_packed(qw, ql, tw, tl)
        )
        for i, (q, t) in enumerate(zip(qs, ts)):
            wd, we = align.best_match_reference(q, t)
            assert (gd[i], ge[i]) == (wd, we), (i, q, t)

    def test_exact_occurrence(self, rng):
        t = _rand_seq(rng, 100)
        q = t[40:57]
        qw, ql = _pack_batch([q])
        tw, tl = _pack_batch([t])
        d, e = align.best_match_packed(qw, ql, tw, tl)
        assert int(d[0]) == 0
        # first exact end is at or before 57 (repeats may occur earlier)
        assert 0 < int(e[0]) <= 57

    def test_one_error_occurrence(self):
        t = b"G" * 30 + b"ACGTACGT" + b"G" * 30
        q = b"ACGAACGT"  # one substitution vs the embedded block
        qw, ql = _pack_batch([q])
        tw, tl = _pack_batch([t])
        d, e = align.best_match_packed(qw, ql, tw, tl)
        assert int(d[0]) == 1
        assert int(e[0]) == 38


class TestDPOracles:
    def test_edit_distance_reference(self):
        assert align.edit_distance_reference(b"ACGT", b"ACGT") == 0
        assert align.edit_distance_reference(b"ACGT", b"") == 4
        assert align.edit_distance_reference(b"AAAA", b"CCCC") == 4
        assert align.edit_distance_reference(b"ACGT", b"AGT") == 1

    def test_best_match_reference(self):
        d, e = align.best_match_reference(b"CG", b"AACGAA")
        assert (d, e) == (0, 4)
        d, e = align.best_match_reference(b"TT", b"ACTA")
        assert d == 1  # the lone text T matches one query T


class TestPeqBytes:
    def test_matches_packed_builder(self, rng):
        q = _rand_seq(rng, 70)
        peq_b, m = align.peq_from_bytes(q)
        qw, ql = _pack_batch([q])
        peq_w = np.asarray(align.peq_from_packed(qw, ql))[0]
        assert m == 70
        np.testing.assert_array_equal(peq_b, peq_w)

    def test_rejects_bad_bytes(self):
        with pytest.raises(ValueError):
            align.peq_from_bytes(b"ACGX")
        with pytest.raises(ValueError):
            align.peq_from_bytes(b"")

    def test_wildcard_all_planes(self):
        peq, m = align.peq_from_bytes(b"ANa")
        assert m == 3
        for c in range(4):
            assert (peq[c, 0] >> 1) & 1 == 1  # N row set everywhere
        assert peq[0, 0] & 1 and peq[0, 0] & 4  # A rows in the A plane

    def test_best_match_peq_wildcard(self, rng):
        texts = [b"GGGGGGATTACAGGGG", b"GGGGGGACTACAGGGG", b"G" * 16]
        tw, tl = _pack_batch(texts)
        peq, m = align.peq_from_bytes(b"GANTACA")
        import jax.numpy as jnp

        B = len(texts)
        d, e = align.best_match_peq(
            jnp.broadcast_to(jnp.asarray(peq)[None], (B,) + peq.shape),
            jnp.full((B,), m, jnp.int32),
            jnp.asarray(tw),
            jnp.asarray(tl),
        )
        # wildcard third position: GATTACA and GACTACA both hit exactly
        assert list(np.asarray(d)) == [0, 0, 5]  # all-G: only G matches


class TestStream:
    """best_match_stream: lane-parallel one-stream scan vs the DP oracle."""

    def test_vs_dp_random(self, rng):
        L = 640
        s = _rand_seq(rng, L)
        w = spec.u64_to_u32_pairs(oracle.n_to_bits_lut(s)).reshape(-1)
        for q in (b"GATTACAGG", b"ACGTACGTACGTACG"):
            d, e = align.best_match_stream(w, L, q)
            assert (d, e) == align.best_match_reference(q, s), q

    def test_planted_at_row_seam(self, rng):
        q = b"GATTACAGATTACA"
        L = 2048
        s = np.frombuffer(_rand_seq(rng, L), np.uint8).copy()
        W = 2 * len(oracle.n_to_bits_lut(b"A" * L))
        _, wrb, _ = align.stream_rows_plan(W, len(q))
        mut = bytearray(q)
        mut[5] = ord("G")  # one substitution (C -> G)
        seam = 16 * wrb
        s[seam - 7 : seam - 7 + len(q)] = np.frombuffer(bytes(mut), np.uint8)
        w = spec.u64_to_u32_pairs(oracle.n_to_bits_lut(s)).reshape(-1)
        d, e = align.best_match_stream(w, L, q)
        assert (d, e) == align.best_match_reference(q, bytes(s))
        assert d <= 1

    def test_trivial_and_wildcard(self):
        s = b"G" * 500
        w = spec.u64_to_u32_pairs(oracle.n_to_bits_lut(s)).reshape(-1)
        # nothing beats the empty-substring alignment -> (m, 0)
        assert align.best_match_stream(w, 500, b"AAAA") == (4, 0)
        # N wildcard matches the Gs exactly
        assert align.best_match_stream(w, 500, b"GNNG") == (0, 4)

    def test_length_guard(self):
        w = np.zeros(4, np.uint32)
        with pytest.raises(ValueError):
            align.best_match_stream(w, 65, b"ACG")
        with pytest.raises(ValueError):
            align.best_match_stream(w.reshape(2, 2), 30, b"ACG")


def _walk_cigar(q, w, d, s, e, cig):
    """Replay the CIGAR and confirm it spells an alignment of cost d."""
    import re

    i, j, cost = 0, s, 0
    for num, op in re.findall(r"(\d+)([MID])", cig):
        k = int(num)
        if op == "M":
            for _ in range(k):
                cost += ((q[i] >> 1) & 3) != ((w[j] >> 1) & 3)
                i += 1
                j += 1
        elif op == "I":
            cost += k
            i += k
        else:
            cost += k
            j += k
    assert i == len(q) and j == e and cost == d, (cig, s, e, d, cost)


class TestTraceback:
    def test_exact(self):
        d, s, e, cig = align.semiglobal_traceback(b"GATTACA", b"GGGGATTACAG")
        assert (d, s, e, cig) == (0, 3, 10, "7M")

    def test_substitution(self):
        d, s, e, cig = align.semiglobal_traceback(b"GATTCCA", b"GGGGATTACAG")
        assert (d, cig) == (1, "7M") and (s, e) == (3, 10)

    def test_random_consistency(self, rng):
        for _ in range(25):
            q = _rand_seq(rng, int(rng.integers(3, 20)))
            w = _rand_seq(rng, int(rng.integers(1, 60)))
            d, s, e, cig = align.semiglobal_traceback(q, w)
            assert d == align.best_match_reference(q, w)[0]
            _walk_cigar(q, w, d, s, e, cig)

    def test_wildcard_agrees_with_device(self):
        # the review repro: query 'AN' vs text 'AT' must be a free match
        d, s, e, cig = align.semiglobal_traceback(b"AN", b"AT")
        assert (d, s, e, cig) == (0, 0, 2, "2M")
        d, s, e, cig = align.semiglobal_traceback(b"GANTACA", b"GGGGACTACAG")
        assert (d, cig) == (0, "7M")


def _pack_b5(seqs):
    lens = np.array([len(s) for s in seqs], np.int32)
    wmax = 2 * max(1, -(-int(lens.max()) // 27))
    words = np.zeros((len(seqs), wmax), np.uint32)
    for i, s in enumerate(seqs):
        if len(s):
            w = spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(s)).reshape(-1)
            words[i, : len(w)] = w
    return words, lens


def _rand_seq_n(rng, n):
    return bytes(rng.choice(list(b"ACGTN"), size=n).astype(np.uint8))


class TestB5:
    @pytest.mark.parametrize("m,n", [(7, 9), (30, 60), (40, 90)])
    def test_global_vs_dp(self, rng, m, n):
        B = 10
        qs = [_rand_seq_n(rng, int(rng.integers(0, m + 1))) for _ in range(B)]
        ts = [_rand_seq_n(rng, int(rng.integers(0, n + 1))) for _ in range(B)]
        qw, ql = _pack_b5(qs)
        tw, tl = _pack_b5(ts)
        got = np.asarray(align.edit_distance_packed_b5(qw, ql, tw, tl))
        want = [
            align.edit_distance_reference_b5(q, t) for q, t in zip(qs, ts)
        ]
        np.testing.assert_array_equal(got, want)

    def test_n_is_literal(self):
        # N matches N for free, mismatches a base — unlike the 2-bit tier
        qw, ql = _pack_b5([b"ACNGT", b"ACNGT"])
        tw, tl = _pack_b5([b"ACNGT", b"ACCGT"])
        got = np.asarray(align.edit_distance_packed_b5(qw, ql, tw, tl))
        np.testing.assert_array_equal(got, [0, 1])

    def test_semiglobal_vs_dp(self, rng):
        B = 8
        qs = [_rand_seq_n(rng, int(rng.integers(1, 25))) for _ in range(B)]
        ts = [_rand_seq_n(rng, int(rng.integers(0, 80))) for _ in range(B)]
        qw, ql = _pack_b5(qs)
        tw, tl = _pack_b5(ts)
        gd, ge = (
            np.asarray(x)
            for x in align.best_match_packed_b5(qw, ql, tw, tl)
        )
        for i, (q, t) in enumerate(zip(qs, ts)):
            wd, we = align.best_match_reference_b5(q, t)
            assert (gd[i], ge[i]) == (wd, we), (i, q, t)

    def test_block_seams(self, rng):
        for m in (31, 32, 33, 64, 65):
            q = _rand_seq_n(rng, m)
            t = _rand_seq_n(rng, m + 9)
            qw, ql = _pack_b5([q])
            tw, tl = _pack_b5([t])
            got = int(align.edit_distance_packed_b5(qw, ql, tw, tl)[0])
            assert got == align.edit_distance_reference_b5(q, t), m


class TestModes:
    """prefix (SHW) + thresholded all-ends vs brute-force DP."""

    def test_prefix_vs_dp(self, rng):
        for _ in range(12):
            q = _rand_seq(rng, int(rng.integers(1, 40)))
            t = _rand_seq(rng, int(rng.integers(0, 80)))
            qw, ql = _pack_batch([q])
            tw, tl = _pack_batch([t])
            d, e = align.prefix_distance_packed(qw, ql, tw, tl)
            cq = (np.frombuffer(q, np.uint8) >> 1) & 3
            ct = (np.frombuffer(t, np.uint8) >> 1) & 3
            m, n = len(cq), len(ct)
            D = np.zeros((m + 1, n + 1), np.int64)
            D[0] = np.arange(n + 1)
            D[:, 0] = np.arange(m + 1)
            for i in range(1, m + 1):
                for j in range(1, n + 1):
                    D[i, j] = min(
                        D[i - 1, j - 1] + (cq[i - 1] != ct[j - 1]),
                        D[i - 1, j] + 1,
                        D[i, j - 1] + 1,
                    )
            assert (int(d[0]), int(e[0])) == (
                int(D[m].min()),
                int(np.argmin(D[m])),
            ), (q, t)

    def test_prefix_known(self):
        # query explains the first 6 text chars with one error
        qw, ql = _pack_batch([b"GATTAC"])
        tw, tl = _pack_batch([b"GATAACGGGG"])
        d, e = align.prefix_distance_packed(qw, ql, tw, tl)
        assert int(d[0]) == 1 and 0 < int(e[0]) <= 7

    def test_match_ends_vs_dp(self, rng):
        B = 6
        qs = [_rand_seq(rng, int(rng.integers(2, 12))) for _ in range(B)]
        ts = [_rand_seq(rng, int(rng.integers(1, 50))) for _ in range(B)]
        qw, ql = _pack_batch(qs)
        tw, tl = _pack_batch(ts)
        errs = np.array([1 + (i % 3) for i in range(B)], np.int32)
        got = np.asarray(
            align.match_ends_packed(qw, ql, tw, tl, errs)
        )
        for b, (q, t) in enumerate(zip(qs, ts)):
            cq = (np.frombuffer(q, np.uint8) >> 1) & 3
            ct = (np.frombuffer(t, np.uint8) >> 1) & 3
            m = len(cq)
            prev = np.arange(m + 1, dtype=np.int64)
            for j, x in enumerate(ct):
                cur = np.empty_like(prev)
                cur[0] = 0
                for i in range(1, m + 1):
                    cur[i] = min(
                        prev[i - 1] + (cq[i - 1] != x),
                        prev[i] + 1,
                        cur[i - 1] + 1,
                    )
                prev = cur
                assert bool(got[b, j]) == (prev[m] <= errs[b]), (b, j)
            assert not got[b, len(t):].any()  # past tlen: always False

    def test_match_ends_no_limit_respects_tlens(self, rng):
        """max_errors == INT32_MAX (a natural 'no limit') must still keep
        positions at and past tlens False — the frozen-state score
        sentinel is INT32_MAX too (r05 review)."""
        qs = [b"GATTACA"] * 3
        ts = [_rand_seq(rng, n) for n in (40, 13, 1)]
        qw, ql = _pack_batch(qs)
        tw, tl = _pack_batch(ts)
        got = np.asarray(
            align.match_ends_packed(
                qw, ql, tw, tl, jnp.full(3, 2**31 - 1, jnp.int32)
            )
        )
        for b, t in enumerate(ts):
            assert got[b, : len(t)].all()  # no limit: every real end
            assert not got[b, len(t):].any()

    def test_best_match_stream_query_longer_than_panel(self, rng):
        """Halos spanning more successor rows than exist (long query on a
        short stream) must scan, not crash (r05 review reproducer)."""
        from cute_nucleotides_jax.ops import oracle as _oracle, spec as _spec

        for L, m in ((160, 120), (32, 30)):
            t = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
            q = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=m))
            t[L - m - 1 : L - 1] = np.frombuffer(q, np.uint8)
            w = jnp.asarray(
                _spec.u64_to_u32_pairs(_oracle.n_to_bits_lut(t)).reshape(-1)
            )
            d, e = align.best_match_stream(w, L, q)
            dw, _ = align.best_match_reference(q, bytes(t))
            assert int(d) == dw, (L, m)


class TestStreamB5:
    def test_vs_dp_random(self, rng):
        L = 540
        s = _rand_seq_n(rng, L)
        w = spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(s)).reshape(-1)
        for q in (b"GATTACAGN", b"ACGTNACGTNACGT"):
            d, e = align.best_match_stream_b5(w, L, q)
            # oracle: N literal -> plain digit DP
            assert (d, e) == align.best_match_reference_b5(q, s), q

    def test_planted_at_row_seam(self, rng):
        q = b"GATTACANGATTACA"
        L = 2700
        s = bytearray(_rand_seq_n(rng, L))
        Wp = -(-L // 27)
        _, prb, _ = align.stream_rows_plan_b5(Wp, len(q))
        mut = bytearray(q)
        mut[4] = ord("G")  # one substitution (A -> G)
        seam = 27 * prb
        s[seam - 6 : seam - 6 + len(q)] = bytes(mut)
        w = spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(bytes(s))).reshape(-1)
        d, e = align.best_match_stream_b5(w, L, bytes(q))
        assert (d, e) == align.best_match_reference_b5(bytes(q), bytes(s))
        assert d <= 1

    def test_wildcard_and_guards(self):
        s = b"N" * 270
        w = spec.u64_to_u32_pairs(oracle.n_to_bits2_lut(s)).reshape(-1)
        # '?' matches the N run; literal A does not
        assert align.best_match_stream_b5(w, 270, b"????") == (0, 4)
        assert align.best_match_stream_b5(w, 270, b"AAAA") == (4, 0)
        with pytest.raises(ValueError):
            align.best_match_stream_b5(w[:-1], 100, b"ACG")  # odd words

    def test_empty_stream(self):
        assert align.best_match_stream(
            np.zeros(0, np.uint32), 0, b"ACG"
        ) == (3, 0)
        assert align.best_match_stream_b5(
            np.zeros(0, np.uint32), 0, b"ACG"
        ) == (3, 0)
