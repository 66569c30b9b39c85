// LSH band fingerprints of the SMH aux bank (parallel/screened.
// band_fingerprints) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's band_fingerprints
// (cuda_selection_criteria_tpu/parallel/screened.py:98), an XLA fusion of
// the FNV limb walk; not a Pallas kernel. The JAX plan ran its host twin
// band_fingerprints_np on the sorted, zero-padded aux bank to save the
// TPU's link bytes; here the bank is on the card already. Plain PyTorch
// version: parallel/screened.py:_band_fingerprints_plain (int64 ops).
//
// What it computes: for each sorted position g < n_pos and band b <
// n_bands, over the n_rows 64-bit words j of band b of aux row rows[g]
// (words b * n_rows + j of the row, m = n_rows * n_bands words a row),
// the low 32-bit limb and then the high one:
//     fp = (fp ^ limb) * 16777619  (uint32, from 2166136261),
// written as int32 fp[g, b]. The map's padded positions name the bank's
// zero row, whose fingerprint is the zero row's, as the JAX plan's
// zero-padded aux gives.
//
// Bound on the card: the aux rows read once, the map read once and the
// fingerprints written once (smh_a-524k: 128 MiB + 2 MiB + 16 MiB, 0.046
// ms at 3.35 TB/s); the work is four integer operations a word, far below
// the memory time.
//
// Design. One thread a (position, band), neighbouring threads on
// neighbouring bands of one row, so that the threads of a row read its
// words end to end and a warp covers whole rows (m = 32: four 256-byte
// rows a warp), and the fingerprints are written end to end. A band of an
// even number of words is read 16 bytes at a time (the rows and the
// bands then start 16-byte aligned), an odd one 8. Each thread reads its
// row index once; rows sorted by cardinality are scattered in the bank,
// so the reads are row-sized gathers, not a stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kBasis = 2166136261u;
constexpr uint32_t kPrime = 16777619u;

__device__ __forceinline__ uint32_t mix(uint32_t fp, uint64_t w) {
  fp = (fp ^ (uint32_t)w) * kPrime;
  return (fp ^ (uint32_t)(w >> 32)) * kPrime;
}

// grid (ceil(n_pos * n_bands / kThreads),), block (kThreads,)
template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
band_fp_kernel(const uint64_t* __restrict__ aux, long long m,
               const int32_t* __restrict__ rows, long long n_pos,
               int n_rows, int n_bands, int32_t* __restrict__ fp) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_pos * n_bands) return;
  const long long g = t / n_bands;
  const int b = (int)(t - g * n_bands);
  const uint64_t* w = aux + (long long)__ldg(rows + g) * m +
                      (long long)b * n_rows;
  uint32_t h = kBasis;
  if (kPairs) {
    const ulonglong2* v = reinterpret_cast<const ulonglong2*>(w);
    for (int j = 0; j < n_rows / 2; ++j) {
      const ulonglong2 q = __ldg(v + j);
      h = mix(mix(h, q.x), q.y);
    }
  } else {
    for (int j = 0; j < n_rows; ++j) h = mix(h, __ldg(w + j));
  }
  fp[t] = (int32_t)h;
}

}  // namespace

// Launches the fingerprints of the n_pos positions of `rows` (int32, each
// a row of the (rows of aux) x m uint64 bank at aux) on `stream` into fp
// (int32 n_pos x n_bands); m = n_rows * n_bands. The caller checks the
// shapes and the map's range. Returns the cudaError_t of the launch;
// n_pos * n_bands == 0 launches nothing. Nothing is allocated here.
extern "C" int csc_band_fp(const void* aux, long long m, const void* rows,
                           long long n_pos, int n_rows, int n_bands,
                           void* fp, void* stream) {
  const long long n_out = n_pos * n_bands;
  if (n_out <= 0) return (int)cudaSuccess;
  if (n_rows < 1 || (long long)n_rows * n_bands != m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
  const uint64_t* a = static_cast<const uint64_t*>(aux);
  const int32_t* r = static_cast<const int32_t*>(rows);
  int32_t* out = static_cast<int32_t*>(fp);
  if (n_rows % 2 == 0 && reinterpret_cast<uintptr_t>(aux) % 16 == 0)
    band_fp_kernel<true><<<blocks, kThreads, 0, st>>>(a, m, r, n_pos, n_rows,
                                                       n_bands, out);
  else
    band_fp_kernel<false><<<blocks, kThreads, 0, st>>>(a, m, r, n_pos,
                                                        n_rows, n_bands, out);
  return (int)cudaGetLastError();
}
