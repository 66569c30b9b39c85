// fastx: native FASTA ingestion + host-side sketch construction.
//
// Copy of cuda_selection_criteria_tpu/native/fastx.cpp for the torch port,
// plus fastx_row_hist (the row histograms of the bank's cardinalities) and
// fastx_zlib_version. Its host presence scan (fastx_value_presence) and
// bit-plane packers (pack_one_row, fastx_pack_bitplanes,
// fastx_gather_pack_bitplanes) serve the packed bank upload
// (ops/regpack.py, parallel/screened.upload_sorted_rows(pack=)).
//
// Replacement for the reference's SeqAn-based scanner
// (reference: src/build_sketch.cpp:41-95 + seqan seq_io) and its OpenMP
// sketch builders. Two roles:
//   1. fast gzip FASTA -> 2-bit code stream producer feeding the device
//      sketch builds (codes: 0..3 = ACGT, 4 = reset sentinel);
//   2. a complete host-side single-pass builder (HLL + SuperMinHash), the
//      build_sketch --backend native path and a differential oracle
//      against the device path.
//
// C ABI, consumed from Python via ctypes (native/fastx.py), which builds
// it at first use (ops/_build.build_host: g++ -O3 -shared -lz -lpthread).

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint8_t kSentinel = 4;

struct CodeLut {
  uint8_t map[256];
  CodeLut() {
    std::memset(map, kSentinel, sizeof(map));
    map[(unsigned)'A'] = map[(unsigned)'a'] = 0;
    map[(unsigned)'C'] = map[(unsigned)'c'] = 1;
    map[(unsigned)'G'] = map[(unsigned)'g'] = 2;
    map[(unsigned)'T'] = map[(unsigned)'t'] = 3;
  }
};
const CodeLut kLut;

struct Buf {
  uint8_t* data = nullptr;
  size_t len = 0;
  size_t cap = 0;
  bool push(uint8_t v) {
    if (len == cap) {
      size_t ncap = cap ? cap * 2 : (1u << 20);
      auto* nd = static_cast<uint8_t*>(std::realloc(data, ncap));
      if (!nd) return false;
      data = nd;
      cap = ncap;
    }
    data[len++] = v;
    return true;
  }
};

// 64-bit Thomas Wang mix (same function family as sketch WangHash;
// reference: sketch/include/sketch/hash.h:42-53).
inline uint64_t wang64(uint64_t x) {
  x = (~x) + (x << 21);
  x ^= x >> 24;
  x = (x + (x << 3)) + (x << 8);
  x ^= x >> 14;
  x = (x + (x << 2)) + (x << 4);
  x ^= x >> 28;
  x += x << 31;
  return x;
}

// Strand-canonical 2-bit k-mer: min(kmer, revcomp) via pairwise bit
// reversal + complement (reference semantics: src/build_sketch.cpp:26-39).
inline uint64_t canonical64(uint64_t kmer, unsigned k) {
  uint64_t x = kmer;
  x = ((x >> 2) & 0x3333333333333333ULL) | ((x & 0x3333333333333333ULL) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFULL) | ((x & 0x00FF00FF00FF00FFULL) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFULL) | ((x & 0x0000FFFF0000FFFFULL) << 16);
  x = (x >> 32) | (x << 32);
  uint64_t rc = (~x) >> (64 - 2 * k);
  return kmer < rc ? kmer : rc;
}

// wyhash64 counter PRNG step (reference: sketch/include/aesctr/wy.h:45-58).
inline uint64_t wymum_fold(uint64_t a, uint64_t b) {
  __uint128_t r = static_cast<__uint128_t>(a) * b;
  return static_cast<uint64_t>(r) ^ static_cast<uint64_t>(r >> 64);
}

struct StreamScanner {
  // Streaming FASTA/FASTQ state machine over decompressed bytes.
  // SeqAn's readRecord accepts both formats transparently (reference:
  // src/build_sketch.cpp:56 via seq_io); '@' records are FASTQ, whose
  // quality line is LENGTH-tracked (quality bytes may contain '@', '+'
  // or base letters, so only counting bases parses them safely).
  // Multi-line sequence in either format is supported.
  enum State : uint8_t { SEQ, HEADER, PLUS, QUAL };
  State state = SEQ;
  bool line_start = true;
  bool fastq = false;      // current record is FASTQ ('@' header)
  uint64_t seq_len = 0;    // bases seen in the current FASTQ record
  uint64_t qual_left = 0;  // quality bytes still to consume

  template <typename Emit>
  void feed(const uint8_t* p, size_t n, Emit&& emit) {
    for (size_t i = 0; i < n; ++i) {
      uint8_t c = p[i];
      switch (state) {
        case HEADER:
          if (c == '\n') {
            state = SEQ;
            line_start = true;
          }
          continue;
        case PLUS:  // FASTQ '+' separator line: skip to newline
          if (c == '\n') {
            qual_left = seq_len;
            state = qual_left ? QUAL : SEQ;
            line_start = true;
          }
          continue;
        case QUAL:  // exactly seq_len non-newline quality bytes
          if (c == '\n' || c == '\r') continue;
          if (--qual_left == 0) {
            state = SEQ;
            line_start = true;  // next non-newline char starts a header
          }
          continue;
        case SEQ:
          break;
      }
      if (c == '\n' || c == '\r') {
        line_start = (c == '\n') || line_start;
        continue;
      }
      if (line_start && (c == '>' || c == '@')) {
        state = HEADER;
        fastq = (c == '@');
        seq_len = 0;
        emit(kSentinel);  // record boundary resets the k-mer window
        continue;
      }
      if (line_start && fastq && c == '+') {
        state = PLUS;
        continue;
      }
      line_start = false;
      if (fastq) ++seq_len;
      emit(kLut.map[c]);
    }
  }
};

}  // namespace

extern "C" {

// Read a (possibly gzipped) FASTA file into a malloc'd code array.
// Returns 0 on success; caller frees *out with fastx_free.
int fastx_read_codes(const char* path, uint8_t** out, int64_t* out_len) {
  gzFile fp = gzopen(path, "rb");
  if (!fp) return -1;
  gzbuffer(fp, 1u << 20);
  Buf buf;
  StreamScanner scan;
  bool ok = buf.push(kSentinel);  // leading boundary
  static thread_local uint8_t chunk[1u << 20];
  int nread;
  while (ok && (nread = gzread(fp, chunk, sizeof(chunk))) > 0) {
    scan.feed(chunk, static_cast<size_t>(nread),
              [&](uint8_t v) { ok = ok && buf.push(v); });
  }
  int err = 0;
  gzerror(fp, &err);
  gzclose(fp);
  if (!ok || err < 0) {
    std::free(buf.data);
    return -2;
  }
  *out = buf.data;
  *out_len = static_cast<int64_t>(buf.len);
  return 0;
}

void fastx_free(uint8_t* p) { std::free(p); }

// Single-pass host sketch builder: streams one FASTA file and fills
//   regs     : uint8[1 << p]        primary HLL registers (zero-initialized here)
//   regs_aux : uint8[1 << p_aux]    aux HLL registers      (if p_aux > 0)
//   smh      : uint64[m]            SuperMinHash h_ vector (if m > 0)
// Returns number of k-mers consumed, or -1 on error.
int64_t fastx_build_sketches(const char* path, unsigned k, unsigned p,
                             uint8_t* regs, unsigned p_aux, uint8_t* regs_aux,
                             unsigned m, uint64_t* smh) {
  gzFile fp = gzopen(path, "rb");
  if (!fp) return -1;
  gzbuffer(fp, 1u << 20);

  if (regs) std::memset(regs, 0, size_t(1) << p);
  if (p_aux && regs_aux) std::memset(regs_aux, 0, size_t(1) << p_aux);

  // SuperMinHash working state (Ertl's algorithm with the shrinking upper
  // bound; reference behavior: sketch/include/sketch/bbmh.h:639-670).
  uint64_t smh_a_bound = m ? m - 1 : 0;
  uint64_t smh_i = 0;
  uint32_t* perm = nullptr;
  uint32_t* stamp = nullptr;
  int64_t* hist = nullptr;
  if (m && smh) {
    for (unsigned b = 0; b < m; ++b) smh[b] = ~0ULL;
    perm = static_cast<uint32_t*>(std::calloc(m, sizeof(uint32_t)));
    stamp = static_cast<uint32_t*>(std::malloc(m * sizeof(uint32_t)));
    hist = static_cast<int64_t*>(std::calloc(m, sizeof(int64_t)));
    std::memset(stamp, 0xFF, m * sizeof(uint32_t));
    hist[m - 1] = m;
  }

  const uint64_t kmask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  uint64_t window = 0;
  unsigned fill = 0;
  int64_t n_kmers = 0;

  auto add_kmer = [&](uint64_t km) {
    ++n_kmers;
    if (regs) {
      uint64_t h = wang64(km);
      unsigned idx = unsigned(h >> (64 - p));
      uint8_t rank = uint8_t(__builtin_clzll(((h << 1) | 1) << (p - 1)) + 1);
      if (regs[idx] < rank) regs[idx] = rank;
    }
    if (p_aux && regs_aux) {
      uint64_t h = wang64(km);
      unsigned idx = unsigned(h >> (64 - p_aux));
      uint8_t rank =
          uint8_t(__builtin_clzll(((h << 1) | 1) << (p_aux - 1)) + 1);
      if (regs_aux[idx] < rank) regs_aux[idx] = rank;
    }
    if (m && smh) {
      uint64_t state = km ? km : 1337;  // WyRand zero-seed remap (wy.h:113)
      const uint64_t kInc = 0x60bee2bee120fc15ULL;
      const uint64_t kXor = 0xe7037ed1a0b428dbULL;
      for (uint64_t j = 0; j <= smh_a_bound; ++j) {
        state += kInc;
        uint64_t draw = wymum_fold(state ^ kXor, state);
        uint32_t kk = uint32_t(draw) & (m - 1);
        uint64_t r = draw >> 32;
        // lazy per-item identity reset of the permutation
        if (stamp[j] != smh_i) { stamp[j] = uint32_t(smh_i); perm[j] = uint32_t(j); }
        if (stamp[kk] != smh_i) { stamp[kk] = uint32_t(smh_i); perm[kk] = kk; }
        uint32_t t = perm[kk]; perm[kk] = perm[j]; perm[j] = t;
        uint64_t cand = (j << 32) | r;
        uint32_t bucket = perm[j];
        if (cand < smh[bucket]) {
          uint64_t jp = smh[bucket] >> 32;
          if (jp > m - 1) jp = m - 1;
          smh[bucket] = cand;
          if (j < jp) {
            --hist[jp];
            ++hist[j];
            while (hist[smh_a_bound] == 0) --smh_a_bound;
          }
        }
      }
      ++smh_i;
    }
  };

  StreamScanner scan;
  static thread_local uint8_t chunk[1u << 20];
  int nread;
  while ((nread = gzread(fp, chunk, sizeof(chunk))) > 0) {
    scan.feed(chunk, static_cast<size_t>(nread), [&](uint8_t code) {
      if (code >= 4) {
        window = 0;
        fill = 0;
        return;
      }
      window = ((window << 2) | code) & kmask;
      if (++fill == k) {
        add_kmer(canonical64(window, k));
        --fill;
      }
    });
  }
  int err = 0;
  gzerror(fp, &err);
  gzclose(fp);
  std::free(perm);
  std::free(stamp);
  std::free(hist);
  return err < 0 ? -1 : n_kmers;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Threaded batch sketch-bank loaders. The reference re-opens one gz file per
// genome per sketch on a single thread (src/selection.cpp:245-246); loading a
// 10^5-genome bank that way is IO-bound cold-start. These read many files in
// parallel straight into the packed (N, 2^p) / (N, m) arrays the device
// engine consumes.
//
// .hll format (sketch hll_t::write, reference hll.h:1103-1111):
//   gz[ u32 is_calculated, u32 estim, u32 jestim, u32 1, u32 np,
//       f64 value, u8 core[2^np] ]
// .smh format (this project's write_smh parity, src/build_sketch.cpp:9-20):
//   gz[ u32 size, u64 h[size] ]

static int read_one_hll(const char* path, unsigned expect_p, uint8_t* out) {
  gzFile fp = gzopen(path, "rb");
  if (!fp) return -1;
  gzbuffer(fp, 1u << 18);
  uint32_t head[5];
  double value;
  if (gzread(fp, head, sizeof(head)) != (int)sizeof(head) ||
      gzread(fp, &value, sizeof(value)) != (int)sizeof(value)) {
    gzclose(fp);
    return -2;
  }
  if (head[4] != expect_p) {
    gzclose(fp);
    return -3;
  }
  size_t n = size_t(1) << expect_p;
  size_t got = 0;
  while (got < n) {
    int r = gzread(fp, out + got, (unsigned)(n - got));
    if (r <= 0) break;
    got += (size_t)r;
  }
  gzclose(fp);
  return got == n ? 0 : -4;
}

static int read_one_smh(const char* path, unsigned expect_m, uint64_t* out) {
  gzFile fp = gzopen(path, "rb");
  if (!fp) return -1;
  uint32_t size = 0;
  if (gzread(fp, &size, sizeof(size)) != (int)sizeof(size) ||
      size != expect_m) {
    gzclose(fp);
    return -3;
  }
  size_t bytes = sizeof(uint64_t) * expect_m;
  size_t got = 0;
  auto* p = reinterpret_cast<uint8_t*>(out);
  while (got < bytes) {
    int r = gzread(fp, p + got, (unsigned)(bytes - got));
    if (r <= 0) break;
    got += (size_t)r;
  }
  gzclose(fp);
  return got == bytes ? 0 : -4;
}

template <typename Fn>
static int batch_run(int n, int n_threads, Fn&& fn) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      int rc = fn(i);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return err.load();
}

extern "C" {

// paths: array of n C strings. regs_out: uint8[n][1 << p]. Returns 0 or the
// first per-file error code.
int fastx_read_hll_batch(const char* const* paths, int n, int n_threads,
                         unsigned p, uint8_t* regs_out) {
  const size_t stride = size_t(1) << p;
  return batch_run(n, n_threads, [&](int i) {
    return read_one_hll(paths[i], p, regs_out + stride * (size_t)i);
  });
}

// paths: array of n C strings. out: uint64[n][m].
int fastx_read_smh_batch(const char* const* paths, int n, int n_threads,
                         unsigned m, uint64_t* out) {
  return batch_run(n, n_threads, [&](int i) {
    return read_one_smh(paths[i], m, out + (size_t)m * (size_t)i);
  });
}

// Exact union-register histograms for candidate pairs:
//   out[b][v] = #{ r < m : max(regs[ii[b]][r], regs[kk[b]][r]) == v }
// for v in [0, 64). This is the confirm stage's hot loop (the reference
// computes it per pair inside hll_t::union_size via sum_counts,
// hll.h:564-583); a fused gather+max+histogram pass touches each register
// byte exactly once, where the vectorized numpy form streams the merged
// array through a 64-bit widen + bincount (~6x the memory traffic).
// Four interleaved sub-histograms break the store-to-load dependency
// chain of the counter increments. Sub-histograms are 256-entry so a
// corrupt register value can never write out of bounds; any value >= 64
// (impossible for well-formed HLL ranks, q+1 <= 63 for p >= 2) returns
// an error instead of silently folding into a neighbor's bins.
// Returns 0, -1 on bad args, -2 on an out-of-range register value,
// -3 on an out-of-range row index.
int fastx_pair_union_hist(const uint8_t* regs, int64_t n_rows, int64_t m,
                          const int64_t* ii, const int64_t* kk,
                          int64_t n_pairs, int n_threads, int64_t* out) {
  if (!regs || !ii || !kk || !out || n_rows < 0 || m < 0 || n_pairs < 0)
    return -1;
  return batch_run((int)n_pairs, n_threads, [&](int b) {
    // mm is a by-value local: the by-ref capture's loop bound can't be
    // proven invariant against the uint8 stores (char aliases all), which
    // blocks vectorization of the max pass entirely.
    const int64_t mm = m;
    int64_t i = ii[b], k = kk[b];
    if (i < 0 || i >= n_rows || k < 0 || k >= n_rows) return -3;
    const uint8_t* __restrict a = regs + (size_t)i * (size_t)mm;
    const uint8_t* __restrict c = regs + (size_t)k * (size_t)mm;
    // Two passes beat one fused loop here: the max pass auto-vectorizes
    // (32 bytes/cycle) into an L1-resident scratch row, leaving the
    // scalar counter pass pure loads+increments (~40% faster measured).
    static thread_local std::vector<uint8_t> merged;
    if ((int64_t)merged.size() < mm) merged.resize(mm);
    uint8_t* __restrict buf = merged.data();
    for (int64_t j = 0; j < mm; ++j) buf[j] = a[j] > c[j] ? a[j] : c[j];
    uint32_t h[4][256];
    std::memset(h, 0, sizeof(h));
    int64_t j = 0;
    for (; j + 4 <= mm; j += 4) {
      ++h[0][buf[j]];
      ++h[1][buf[j + 1]];
      ++h[2][buf[j + 2]];
      ++h[3][buf[j + 3]];
    }
    for (; j < mm; ++j) ++h[0][buf[j]];
    int64_t* o = out + (size_t)b * 64;
    uint64_t tail = 0;
    for (int v = 0; v < 64; ++v)
      o[v] = (int64_t)h[0][v] + h[1][v] + h[2][v] + h[3][v];
    for (int v = 64; v < 256; ++v)
      tail += (uint64_t)h[0][v] + h[1][v] + h[2][v] + h[3][v];
    return tail ? -2 : 0;
  });
}

// Register histograms of every row of a bank:
//   out[r][v] = #{ j < m : regs[r][j] == v }
// for v in [0, 64): the histograms the cardinalities are computed from.
// One pass over each row, each byte read once, with the four interleaved
// 256-entry sub-histograms of fastx_pair_union_hist. A value >= 64 is an
// error, where a flat offset bincount would fold it into the next row.
// Returns 0, -1 on bad args, -2 on an out-of-range register value.
int fastx_row_hist(const uint8_t* regs, int64_t n_rows, int64_t m,
                   int n_threads, int64_t* out) {
  if (!regs || !out || n_rows < 0 || n_rows > INT32_MAX || m < 0 ||
      m > INT32_MAX)
    return -1;
  return batch_run((int)n_rows, n_threads, [&](int r) {
    const int64_t mm = m;
    const uint8_t* __restrict a = regs + (size_t)r * (size_t)mm;
    uint32_t h[4][256];
    std::memset(h, 0, sizeof(h));
    int64_t j = 0;
    for (; j + 4 <= mm; j += 4) {
      ++h[0][a[j]];
      ++h[1][a[j + 1]];
      ++h[2][a[j + 2]];
      ++h[3][a[j + 3]];
    }
    for (; j < mm; ++j) ++h[0][a[j]];
    int64_t* o = out + (size_t)r * 64;
    uint64_t tail = 0;
    for (int v = 0; v < 64; ++v)
      o[v] = (int64_t)h[0][v] + h[1][v] + h[2][v] + h[3][v];
    for (int v = 64; v < 256; ++v)
      tail += (uint64_t)h[0][v] + h[1][v] + h[2][v] + h[3][v];
    return tail ? -2 : 0;
  });
}

// Presence scan: out[v] = 1 iff byte value v occurs in the array. One
// linear pass split across the pool: the alphabet of a packed upload
// (ops/regpack.host_values), read from the host bank before it goes to the
// device.
int fastx_value_presence(const uint8_t* data, int64_t n, int n_threads,
                         uint8_t* out256) {
  if (!data || !out256 || n < 0) return -1;
  std::memset(out256, 0, 256);
  const int nt = n_threads < 1 ? 1 : n_threads;
  std::vector<std::array<uint8_t, 256>> seen(nt);
  for (auto& s : seen) s.fill(0);
  const int64_t chunk = (n + nt - 1) / nt;
  int rc = batch_run(nt, nt, [&](int t) {
    const int64_t lo = (int64_t)t * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    auto& s = seen[t];
    for (int64_t i = lo; i < hi; ++i) s[data[i]] = 1;
    return 0;
  });
  for (auto& s : seen)
    for (int v = 0; v < 256; ++v) out256[v] |= s[v];
  return rc;
}

// Bit-plane register packing for the host->device bank upload
// (ops/regpack.py): rows -> value-index bit-planes, little bit order
// within each byte (== np.packbits(bitorder="little")). One pass per
// slab: each 8-register group is LUT'd into a u64 word and plane j's
// byte falls out of the classic SWAR bit-gather multiply. out layout:
// (s, k, r/8) C-contiguous. r must be a multiple of 8. n_threads rows
// are split across the pool (the numpy form re-reads the slab once a
// plane; this reads it once).
static inline void pack_one_row(const uint8_t* __restrict src,
                                uint8_t* __restrict dst,
                                const uint8_t* __restrict lut, int k,
                                int64_t r8) {
  const uint64_t m1 = 0x0101010101010101ULL;
  const uint64_t m2 = 0x0102040810204080ULL;
  for (int64_t g = 0; g < r8; ++g) {
    uint64_t w = 0;
    for (int j = 0; j < 8; ++j)
      w |= (uint64_t)lut[src[g * 8 + j]] << (8 * j);
    for (int j = 0; j < k; ++j)
      dst[(size_t)j * r8 + g] = (uint8_t)((((w >> j) & m1) * m2) >> 56);
  }
}

int fastx_pack_bitplanes(const uint8_t* rows, int64_t s, int64_t r,
                         const uint8_t* lut, int k, int n_threads,
                         uint8_t* out) {
  if (!rows || !lut || !out || s < 0 || r < 0 || (r & 7) || k < 1 || k > 7)
    return -1;
  const int64_t r8 = r / 8;
  return batch_run((int)s, n_threads, [&](int b) {
    pack_one_row(rows + (size_t)b * (size_t)r,
                 out + (size_t)b * (size_t)k * (size_t)r8, lut, k, r8);
    return 0;
  });
}

// Fused gather + pack: slab rows come straight out of the (unsorted)
// bank by index - a separate np.take gather would stream the slab through
// memory twice more (write the arena, then the packer re-reads it); this
// reads each bank row once. idx: int64 sorted-order row indices, one per
// output slab row.
int fastx_gather_pack_bitplanes(const uint8_t* bank, int64_t n_rows,
                                int64_t r, const int64_t* idx, int64_t s,
                                const uint8_t* lut, int k, int n_threads,
                                uint8_t* out) {
  if (!bank || !idx || !lut || !out || s < 0 || r < 0 || (r & 7) ||
      k < 1 || k > 7)
    return -1;
  const int64_t r8 = r / 8;
  return batch_run((int)s, n_threads, [&](int b) {
    const int64_t row = idx[b];
    if (row < 0 || row >= n_rows) return -3;
    pack_one_row(bank + (size_t)row * (size_t)r,
                 out + (size_t)b * (size_t)k * (size_t)r8, lut, k, r8);
    return 0;
  });
}

// zlib as this library sees it: the runtime version, then the header it was
// compiled against, e.g. "1.2.13 (zlib.h 1.2.13)".
const char* fastx_zlib_version() {
  static const std::string s =
      std::string(zlibVersion()) + " (zlib.h " ZLIB_VERSION ")";
  return s.c_str();
}

}  // extern "C"
