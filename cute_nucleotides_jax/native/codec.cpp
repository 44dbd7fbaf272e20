// Native host oracle for the nucleotide codecs.
//
// This is the C++ stand-in for the reference's Rust scalar tier (reference
// src/n_to_bits.rs:34-69, src/n_to_bits2.rs:37-107): a trivially-correct,
// bit-exact implementation of the four core operations, used for
//   * fast host-side parity checking of the device tiers,
//   * ragged-tail handling in the streaming pipeline,
//   * a host throughput baseline in the benchmark harness.
//
// Unlike the reference, out-of-alphabet behavior is *defined* (see
// cute_nucleotides_jax/ops/spec.py): 2-bit code = (byte >> 1) & 3 for every
// byte; base-5 digit = DIGIT_LUT8[byte & 7].  On the alphabet these equal the
// reference's LUTs.
//
// Build: g++ -O3 -march=native -shared -fPIC codec.cpp -o libcutenuc.so
// The loops are written to autovectorize (no hand intrinsics needed for an
// oracle); the hot device path lives in the XLA kernels (ops/xla.py).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint8_t kDigitLut8[8] = {0, 0, 0, 1, 2, 2, 4, 3};  // keyed on c & 7
constexpr uint8_t kBitsToChar[4] = {'A', 'C', 'T', 'G'};
constexpr uint8_t kDigToChar[5] = {'A', 'C', 'T', 'G', 'N'};

}  // namespace

extern "C" {

// --- 2-bit codec -----------------------------------------------------------

// Encode len nucleotides into ceil(len/32) LSB-first u64 words
// (layout contract of reference src/n_to_bits.rs:34-47).
void cutenuc_n_to_bits(const uint8_t* n, size_t len, uint64_t* out) {
  size_t full = len / 32;  // every output word is written below (r05)
  for (size_t w = 0; w < full; ++w) {
    uint64_t acc = 0;
    const uint8_t* p = n + w * 32;
    for (int i = 0; i < 32; ++i) {
      acc |= static_cast<uint64_t>((p[i] >> 1) & 3) << (2 * i);
    }
    out[w] = acc;
  }
  uint64_t acc = 0;
  for (size_t i = full * 32; i < len; ++i) {
    acc |= static_cast<uint64_t>((n[i] >> 1) & 3) << (2 * (i % 32));
  }
  if (len % 32) out[full] = acc;
}

// Decode len nucleotides from LSB-first u64 words.  Caller guarantees
// len <= nwords*32 (checked Python-side, mirroring the reference's panic at
// src/n_to_bits.rs:52-54).
void cutenuc_bits_to_n(const uint64_t* bits, size_t len, uint8_t* out) {
  size_t full = len / 32;
  for (size_t w = 0; w < full; ++w) {
    uint64_t v = bits[w];
    uint8_t* p = out + w * 32;
    for (int i = 0; i < 32; ++i) {
      p[i] = kBitsToChar[(v >> (2 * i)) & 3];
    }
  }
  for (size_t i = full * 32; i < len; ++i) {
    out[i] = kBitsToChar[(bits[i / 32] >> (2 * (i % 32))) & 3];
  }
}

// --- base-5 codec ----------------------------------------------------------

// Encode len nucleotides into ceil(len/27) u64 words: triplet (a,b,c) ->
// c*25 + b*5 + a in 7 bits, 9 triplets LSB-first per word, trailing partial
// triplet with missing digits 0 (contract of reference src/n_to_bits2.rs:37-74).
void cutenuc_n_to_bits2(const uint8_t* n, size_t len, uint64_t* out) {
  size_t full = len / 27;  // every output word is written below (r05)
  for (size_t w = 0; w < full; ++w) {
    uint64_t acc = 0;
    const uint8_t* p = n + w * 27;
    for (int t = 0; t < 9; ++t) {
      uint32_t a = kDigitLut8[p[3 * t] & 7];
      uint32_t b = kDigitLut8[p[3 * t + 1] & 7];
      uint32_t c = kDigitLut8[p[3 * t + 2] & 7];
      acc |= static_cast<uint64_t>(c * 25 + b * 5 + a) << (7 * t);
    }
    out[w] = acc;
  }
  size_t rem = len % 27;
  if (rem) {
    const uint8_t* p = n + full * 27;
    uint64_t acc = 0;
    for (size_t i = 0; i < (rem + 2) / 3; ++i) {
      uint32_t a = kDigitLut8[p[3 * i] & 7];
      uint32_t b = 3 * i + 1 < rem ? kDigitLut8[p[3 * i + 1] & 7] : 0;
      uint32_t c = 3 * i + 2 < rem ? kDigitLut8[p[3 * i + 2] & 7] : 0;
      acc |= static_cast<uint64_t>(c * 25 + b * 5 + a) << (7 * i);
    }
    out[full] = acc;
  }
}

// Decode len nucleotides from base-5 packed words.  Caller guarantees
// len <= nwords*27 (reference panic at src/n_to_bits2.rs:78-80).
void cutenuc_bits_to_n2(const uint64_t* bits, size_t len, uint8_t* out) {
  size_t full = len / 27;
  for (size_t w = 0; w < full; ++w) {
    uint64_t v = bits[w];
    uint8_t* p = out + w * 27;
    for (int t = 0; t < 9; ++t) {
      uint32_t val = (v >> (7 * t)) & 0x7F;
      uint32_t d2 = val / 25;  // 5..: corrupt word (val >= 125); clamp,
      if (d2 > 4) d2 = 4;      // no OOB read — checked decode flags these
      p[3 * t] = kDigToChar[val % 5];
      p[3 * t + 1] = kDigToChar[(val / 5) % 5];
      p[3 * t + 2] = kDigToChar[d2];
    }
  }
  for (size_t i = full * 27; i < len; ++i) {
    uint64_t v = bits[i / 27];
    uint32_t t = (i % 27) / 3;
    uint32_t val = (v >> (7 * t)) & 0x7F;
    uint32_t k = i % 3;
    uint32_t d = k == 0 ? val % 5 : (k == 1 ? (val / 5) % 5 : val / 25);
    if (d > 4) d = 4;  // corrupt word (val >= 125): clamp, no OOB read
    out[i] = kDigToChar[d];
  }
}

// --- utility ---------------------------------------------------------------

// memcpy baseline hook for the bench harness (the reference benches memcpy
// the same way, benches/bench_n_to_bits.rs:20).
void cutenuc_memcpy(const uint8_t* src, size_t len, uint8_t* dst) {
  std::memcpy(dst, src, len);
}

// Batch-assembly fill: scatter `cnt` parsed reads into a fixed-shape padded
// batch (the host stage of the streaming pipeline, utils/io.fastq_batches).
// Row i < cnt gets buf[starts[i] .. starts[i]+min(lens[i],max_len)) followed
// by 'A' padding; rows cnt..rows-1 are all-'A' (the encoder's pad rows).
// One memcpy + one memset per row replaces a per-row Python slice loop, which
// capped the streaming encoder's host stage once parsing itself was
// vectorized.
void cutenuc_fill_rows(const uint8_t* buf, const int64_t* starts,
                       const int64_t* lens, size_t cnt, uint8_t* reads,
                       size_t rows, size_t max_len) {
  for (size_t i = 0; i < cnt; ++i) {
    size_t l = static_cast<size_t>(lens[i]);
    if (l > max_len) l = max_len;
    uint8_t* row = reads + i * max_len;
    std::memcpy(row, buf + starts[i], l);
    std::memset(row + l, 'A', max_len - l);
  }
  if (rows > cnt) {
    std::memset(reads + cnt * max_len, 'A', (rows - cnt) * max_len);
  }
}

// FASTQ chunk scan: parse complete 4-line records from buf[0..n), writing
// the sequence-line span (start, CR-stripped length) per record.  Returns
// the record count (at most cap), or -1 on a malformed record (header not
// '@' or separator line not '+' — the same framing check the NumPy parser
// does).  *consumed is set to the offset just past the last complete
// record; the caller carries buf[consumed..n) into the next chunk.  One
// memchr-driven pass replaces a whole-chunk newline indexing + fancy-slice
// validation pipeline on the Python side.
long long cutenuc_fastq_scan(const uint8_t* buf, size_t n, int64_t* starts,
                             int64_t* lens, size_t cap, int64_t* consumed) {
  size_t p = 0, cnt = 0;
  while (cnt < cap) {
    const uint8_t* h_end =
        static_cast<const uint8_t*>(std::memchr(buf + p, '\n', n - p));
    if (h_end == nullptr) break;
    size_t s0 = static_cast<size_t>(h_end - buf) + 1;
    const uint8_t* s_end = s0 < n
        ? static_cast<const uint8_t*>(std::memchr(buf + s0, '\n', n - s0))
        : nullptr;
    if (s_end == nullptr) break;
    size_t p0 = static_cast<size_t>(s_end - buf) + 1;
    const uint8_t* p_end = p0 < n
        ? static_cast<const uint8_t*>(std::memchr(buf + p0, '\n', n - p0))
        : nullptr;
    if (p_end == nullptr) break;
    size_t q0 = static_cast<size_t>(p_end - buf) + 1;
    const uint8_t* q_end = q0 < n
        ? static_cast<const uint8_t*>(std::memchr(buf + q0, '\n', n - q0))
        : nullptr;
    if (q_end == nullptr) break;
    if (buf[p] != '@' || buf[p0] != '+') return -1;
    size_t slen = p0 - 1 - s0;
    if (slen && buf[s0 + slen - 1] == '\r') --slen;
    starts[cnt] = static_cast<int64_t>(s0);
    lens[cnt] = static_cast<int64_t>(slen);
    ++cnt;
    p = static_cast<size_t>(q_end - buf) + 1;
  }
  *consumed = static_cast<int64_t>(p);
  return static_cast<long long>(cnt);
}

// Validation pass: returns the index of the first byte outside the accepted
// alphabet, or -1 if all bytes are valid.  Accepts {A,C,G,T,U} upper/lower
// and, when allow_n != 0, {N,n}.
long long cutenuc_find_invalid(const uint8_t* n, size_t len, int allow_n) {
  for (size_t i = 0; i < len; ++i) {
    uint8_t c = n[i] & 0xDF;  // fold case (clears bit 5 for letters)
    bool ok = (c == 'A' || c == 'C' || c == 'G' || c == 'T' || c == 'U');
    if (allow_n) ok = ok || (c == 'N');
    if (!ok) return static_cast<long long>(i);
  }
  return -1;
}

}  // extern "C"

// --- Myers bit-parallel edit distance (host tier) ---------------------------
//
// The u64 mirror of the device scan in ops/align.py: the exact wide-word
// emulation of Hyyro's recurrence, 64 DP rows per block, adder carry and
// shift bits chained across blocks.  ASCII in (codes are the (b >> 1) & 3
// fold, 'N'/'n' in the QUERY matches any base); used as the host-latency
// tier and as an independent cross-check of the JAX implementation.

namespace {

void myers_scan(const uint8_t* q, size_t m, const uint8_t* t, size_t n,
                bool semiglobal, int64_t* out_score, int64_t* out_best,
                int64_t* out_best_end) {
  size_t nb = (m + 63) / 64;
  std::vector<uint64_t> peq(4 * nb, 0);
  std::vector<uint64_t> pv(nb, ~0ull), mv(nb, 0), xv(nb), ph(nb), mh(nb);
  for (size_t i = 0; i < m; ++i) {
    uint8_t c = q[i] & 0xDF;
    if (c == 'N') {
      for (int k = 0; k < 4; ++k) peq[k * nb + i / 64] |= 1ull << (i % 64);
    } else {
      peq[((q[i] >> 1) & 3u) * nb + i / 64] |= 1ull << (i % 64);
    }
  }
  int64_t score = static_cast<int64_t>(m);
  int64_t best = score, best_end = 0;
  size_t hb = (m ? m - 1 : 0) / 64;
  int hbit = static_cast<int>((m ? m - 1 : 0) % 64);
  for (size_t j = 0; j < n; ++j) {
    const uint64_t* eq = &peq[static_cast<size_t>((t[j] >> 1) & 3u) * nb];
    uint64_t cin = 0;
    for (size_t b = 0; b < nb; ++b) {
      uint64_t e = eq[b], p = pv[b], mvb = mv[b];
      xv[b] = e | mvb;
      uint64_t a = e & p;
      uint64_t s = a + p + cin;
      cin = (s < a) || (s == a && cin);
      uint64_t xh = (s ^ p) | e;
      ph[b] = mvb | ~(xh | p);
      mh[b] = p & xh;
    }
    score += static_cast<int64_t>((ph[hb] >> hbit) & 1) -
             static_cast<int64_t>((mh[hb] >> hbit) & 1);
    uint64_t phin = semiglobal ? 0 : 1, mhin = 0;
    for (size_t b = 0; b < nb; ++b) {
      uint64_t ps = (ph[b] << 1) | phin, ms = (mh[b] << 1) | mhin;
      phin = ph[b] >> 63;
      mhin = mh[b] >> 63;
      pv[b] = ms | ~(xv[b] | ps);
      mv[b] = ps & xv[b];
    }
    if (score < best) {
      best = score;
      best_end = static_cast<int64_t>(j) + 1;
    }
  }
  *out_score = score;
  *out_best = best;
  *out_best_end = best_end;
}

}  // namespace

extern "C" {

// Global Levenshtein distance over normalized codes.
long long cutenuc_edit_distance(const uint8_t* q, size_t m, const uint8_t* t,
                                size_t n) {
  if (m == 0) return static_cast<long long>(n);
  int64_t score, best, best_end;
  myers_scan(q, m, t, n, false, &score, &best, &best_end);
  return static_cast<long long>(score);
}

// Semiglobal best occurrence: *dist / *end as in align.best_match_packed
// ((m, 0) when nothing beats the empty-substring alignment).
void cutenuc_best_match(const uint8_t* q, size_t m, const uint8_t* t,
                        size_t n, int64_t* dist, int64_t* end) {
  if (m == 0) {
    *dist = 0;
    *end = 0;
    return;
  }
  int64_t score, best, best_end;
  myers_scan(q, m, t, n, true, &score, &best, &best_end);
  *dist = best;
  *end = best_end;
}

// Prefix (SHW) mode: whole query vs the best text PREFIX — the running
// minimum of the global-mode scan (align.prefix_distance_packed's mirror).
void cutenuc_prefix_match(const uint8_t* q, size_t m, const uint8_t* t,
                          size_t n, int64_t* dist, int64_t* end) {
  if (m == 0) {
    *dist = 0;
    *end = 0;
    return;
  }
  int64_t score, best, best_end;
  myers_scan(q, m, t, n, false, &score, &best, &best_end);
  *dist = best;
  *end = best_end;
}

}  // extern "C"
