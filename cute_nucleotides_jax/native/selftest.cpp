// Self-test for the native host oracle, intended to run under sanitizers.
//
// The reference's scalar tier rests on heavy `unsafe` (raw alloc,
// get_unchecked, unions — reference README.md:17-18); this framework's host
// oracle is plain C++ and this binary exercises it end-to-end so CI can run
// it under AddressSanitizer/UBSan (see the Makefile next to it):
//
//   make -C cute_nucleotides_jax/native asan-check
//
// Checks: the reference's golden vectors (src/n_to_bits.rs:413-417,
// src/n_to_bits2.rs:275-279), roundtrips at every length 0..200 (all
// residues mod 32 and mod 27), and arbitrary-byte inputs.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
void cutenuc_n_to_bits(const uint8_t*, size_t, uint64_t*);
void cutenuc_bits_to_n(const uint64_t*, size_t, uint8_t*);
void cutenuc_n_to_bits2(const uint8_t*, size_t, uint64_t*);
void cutenuc_bits_to_n2(const uint64_t*, size_t, uint8_t*);
long long cutenuc_find_invalid(const uint8_t*, size_t, int);
void cutenuc_fill_rows(const uint8_t*, const int64_t*, const int64_t*, size_t,
                       uint8_t*, size_t, size_t);
long long cutenuc_fastq_scan(const uint8_t*, size_t, int64_t*, int64_t*,
                             size_t, int64_t*);
long long cutenuc_edit_distance(const uint8_t*, size_t, const uint8_t*,
                                size_t);
void cutenuc_best_match(const uint8_t*, size_t, const uint8_t*, size_t,
                        int64_t*, int64_t*);
}

static int failures = 0;

#define CHECK(cond, msg)                                   \
  do {                                                     \
    if (!(cond)) {                                         \
      std::fprintf(stderr, "FAIL: %s\n", msg);             \
      ++failures;                                          \
    }                                                      \
  } while (0)

static uint8_t norm(uint8_t c) {
  uint8_t u = c & 0xDF;
  return u == 'U' ? 'T' : u;
}

int main() {
  // golden vectors
  {
    std::vector<uint8_t> s;
    for (int i = 0; i < 8; ++i) s.insert(s.end(), {'A', 'T', 'C', 'G'});
    uint64_t w[1] = {0};
    cutenuc_n_to_bits(s.data(), s.size(), w);
    CHECK(w[0] == 0xD8D8D8D8D8D8D8D8ULL, "2-bit golden vector");
  }
  {
    std::vector<uint8_t> s;
    for (int i = 0; i < 7; ++i) s.insert(s.end(), {'A', 'T', 'C', 'G', 'N'});
    uint64_t w[2] = {0, 0};
    cutenuc_n_to_bits2(s.data(), s.size(), w);
    CHECK(w[0] == 0x36a45d1f46d48ba3ULL && w[1] == 0x5d1f4ULL,
          "base-5 golden vector");
  }

  // roundtrips at every length 0..200 (covers all residues mod 32 / mod 27)
  const char alpha[] = "ACGTUacgtu";
  const char alpha_n[] = "ACGTUNacgtun";
  uint32_t state = 0x5EED;
  auto next = [&state]() {
    state = state * 1664525u + 1013904223u;
    return state >> 16;
  };
  for (size_t n = 0; n <= 200; ++n) {
    std::vector<uint8_t> s(n);
    for (size_t i = 0; i < n; ++i) s[i] = alpha[next() % 10];
    std::vector<uint64_t> w((n + 31) / 32);
    cutenuc_n_to_bits(s.data(), n, w.data());
    std::vector<uint8_t> back(n);
    cutenuc_bits_to_n(w.data(), n, back.data());
    bool ok = true;
    for (size_t i = 0; i < n; ++i) ok &= back[i] == norm(s[i]);
    CHECK(ok, "2-bit roundtrip");

    for (size_t i = 0; i < n; ++i) s[i] = alpha_n[next() % 12];
    std::vector<uint64_t> w5((n + 26) / 27);
    cutenuc_n_to_bits2(s.data(), n, w5.data());
    std::vector<uint8_t> back5(n);
    cutenuc_bits_to_n2(w5.data(), n, back5.data());
    ok = true;
    for (size_t i = 0; i < n; ++i) ok &= back5[i] == norm(s[i]);
    CHECK(ok, "base-5 roundtrip");
  }

  // arbitrary bytes are defined (no UB): run the encoders over all 256 values
  {
    std::vector<uint8_t> s(256);
    for (int i = 0; i < 256; ++i) s[i] = static_cast<uint8_t>(i);
    std::vector<uint64_t> w((256 + 31) / 32), w5((256 + 26) / 27);
    cutenuc_n_to_bits(s.data(), s.size(), w.data());
    cutenuc_n_to_bits2(s.data(), s.size(), w5.data());
    CHECK(cutenuc_find_invalid(s.data(), s.size(), 1) == 0, "find_invalid");
  }

  // batch fill: ragged reads, truncation at max_len, pad rows all-'A'
  {
    const uint8_t buf[] = "ACGTACGTACGTACGTacgtNNNNuuuu";
    const int64_t starts[3] = {0, 4, 16};
    const int64_t lens[3] = {4, 12, 12};  // row 1 truncates at max_len 8
    std::vector<uint8_t> reads(4 * 8, 0xEE);
    cutenuc_fill_rows(buf, starts, lens, 3, reads.data(), 4, 8);
    CHECK(std::memcmp(reads.data(), "ACGTAAAA", 8) == 0, "fill row 0 + pad");
    CHECK(std::memcmp(reads.data() + 8, "ACGTACGT", 8) == 0, "fill truncated");
    CHECK(std::memcmp(reads.data() + 16, "acgtNNNN", 8) == 0, "fill raw bytes");
    CHECK(std::memcmp(reads.data() + 24, "AAAAAAAA", 8) == 0, "fill pad row");
  }

  // FASTQ scan: CRLF strip, incomplete-tail carry, malformed detection
  {
    const char fq[] = "@r1\nACGT\r\n+\nIIII\n@r2\nGG\n+x\nII\n@r3\nAC";
    size_t n = sizeof(fq) - 1;
    int64_t starts[8], lens[8], consumed = 0;
    long long cnt = cutenuc_fastq_scan(
        reinterpret_cast<const uint8_t*>(fq), n, starts, lens, 8, &consumed);
    CHECK(cnt == 2, "fastq_scan count");
    CHECK(starts[0] == 4 && lens[0] == 4, "fastq_scan rec0 (CR stripped)");
    CHECK(std::memcmp(fq + starts[1], "GG", 2) == 0 && lens[1] == 2,
          "fastq_scan rec1");
    CHECK(consumed == 30, "fastq_scan consumed stops before partial rec");
    const char bad[] = "@r\nAC\nX\nII\n";
    cnt = cutenuc_fastq_scan(reinterpret_cast<const uint8_t*>(bad),
                             sizeof(bad) - 1, starts, lens, 8, &consumed);
    CHECK(cnt == -1, "fastq_scan malformed separator");
    // cap smaller than record count: parse stops cleanly at cap
    cnt = cutenuc_fastq_scan(reinterpret_cast<const uint8_t*>(fq), n, starts,
                             lens, 1, &consumed);
    CHECK(cnt == 1 && consumed == 17, "fastq_scan cap");
  }

  // Myers bit-parallel vs naive DP (global + semiglobal, N wildcards,
  // block seams at m = 63/64/65)
  {
    uint64_t st = 0x5EEDULL;
    auto rnd = [&st]() {
      st = st * 6364136223846793005ULL + 1442695040888963407ULL;
      return static_cast<uint32_t>(st >> 33);
    };
    const char alpha[5] = {'A', 'C', 'G', 'T', 'N'};
    for (int iter = 0; iter < 60; ++iter) {
      size_t m = (iter % 20 == 19) ? 63 + (iter / 20) : 1 + rnd() % 80;
      size_t n = rnd() % 120;
      std::vector<uint8_t> q(m), t(n);
      for (auto& c : q) c = alpha[rnd() % 5];  // N in query = wildcard
      for (auto& c : t) c = alpha[rnd() % 4];
      // naive DP over (b >> 1) & 3 codes, query N free
      std::vector<int64_t> prev(n + 1), cur(n + 1);
      for (size_t j = 0; j <= n; ++j) prev[j] = static_cast<int64_t>(j);
      std::vector<int64_t> sprev(n + 1, 0), scur(n + 1);
      int64_t sbest = static_cast<int64_t>(m), sbest_end = 0;
      for (size_t i = 1; i <= m; ++i) {
        cur[0] = static_cast<int64_t>(i);
        scur[0] = static_cast<int64_t>(i);
        bool wild = (q[i - 1] & 0xDF) == 'N';
        for (size_t j = 1; j <= n; ++j) {
          int64_t sub =
              (!wild && ((q[i - 1] >> 1) & 3) != ((t[j - 1] >> 1) & 3));
          cur[j] = std::min(std::min(prev[j - 1] + sub, prev[j] + 1),
                            cur[j - 1] + 1);
          scur[j] = std::min(std::min(sprev[j - 1] + sub, sprev[j] + 1),
                             scur[j - 1] + 1);
        }
        prev.swap(cur);
        sprev.swap(scur);
      }
      for (size_t j = 1; j <= n; ++j) {
        if (sprev[j] < sbest) {
          sbest = sprev[j];
          sbest_end = static_cast<int64_t>(j);
        }
      }
      long long got = cutenuc_edit_distance(q.data(), m, t.data(), n);
      CHECK(got == prev[n], "myers global vs DP");
      int64_t d = 0, e = 0;
      cutenuc_best_match(q.data(), m, t.data(), n, &d, &e);
      CHECK(d == sbest && e == sbest_end, "myers semiglobal vs DP");
    }
  }

  if (failures == 0) {
    std::printf("NATIVE SELFTEST PASS\n");
    return 0;
  }
  std::fprintf(stderr, "%d failures\n", failures);
  return 1;
}
