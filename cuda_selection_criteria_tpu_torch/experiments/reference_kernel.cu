// The reference's own GPU selection kernel, written as the reference wrote
// it, so that its speed on this card can be measured: kernel_CBsmh
// (src/selection_kernels.cu:63-117) with the device functions smh_a and
// hll_union_card (include/criteria_sketch_cuda.cuh:16-28, 30-65). It is a
// measured baseline for experiments/reference_kernel.py, not a kernel of
// the port: nothing on the port's user path calls it, and it replaces no
// TPU kernel.
//
// Its design is the reference's and is kept so: one thread a pair of a
// materialized pair list (int2, i < k over positions sorted by
// cardinality); the smh_a band gate first; for a pair that passes it, the
// register-wise max of the two uint8 rows at p = 14, read one byte at a
// time (no vector loads, no shared memory), sum(2^-r) in f64 in register
// order; Flajolet's ORIGINAL estimator with linear counting and the
// large-range correction (the formula and constants of the JAX package's
// estimators.original_estimate); J = (c_i + c_k - t) / t from the f64
// cards; a J that is not finite or is below tau rejected; the rest
// appended as {x, y, float sim} through atomicAdd on a device counter.
// The threads of a warp read 32 rows 16 KiB apart, byte by byte.
//
// Bound: each pair that passes the gate reads two 16 KiB rows and does
// 2^14 byte maxima, zero tests and f64 adds; the port's bench counts its
// baseline as 2 x 16 KiB a pair at the card's copy rate
// (utils/hopper.card_baseline). This kernel does nothing about its
// bound: making it faster would make it another kernel.
//
// Three deliberate departures from the reference:
//  (a) the aux stride is m, the buckets a row. The reference passes
//      aux_bytes (8m) as the element stride (selection_cuda.cpp:172-173),
//      reads past the end of the aux array for every row but the first,
//      which is undefined behaviour and drops pairs at random.
//  (b) the pair index, the row offsets and the grid are 64-bit, so a list
//      of N(N-1)/2 pairs may pass 2^31; the result counter is 64-bit too.
//  (c) the band count and row count are the caller's, from the port's
//      ops/criteria.smh_band_params (selection.cpp's search with its
//      fallback to m bands of one row; selection_cuda.cpp:119-128 falls
//      back to one band of one row). At m = 32 and tau 0.9 both give 8
//      bands of 4 rows.
// CB stays unapplied, as in the reference: kernel_CBsmh never calls the
// device CB (criteria_sketch_cuda.cuh:11-14 is dead code there), so every
// pair of the list reaches the band gate. That is what the reference
// costs.
//
// Beyond those, a result whose slot would pass the output's capacity is
// counted and not written, where the reference writes past its buffer;
// the wrapper allocates one slot a pair, as the reference does, and
// raises on a count above the capacity.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Result {
  int x, y;
  float sim;
};

constexpr int kP = 14;
constexpr int kM = 1 << kP;

__device__ bool smh_a(const uint64_t* a, const uint64_t* b, int n_rows,
                      int n_bands) {
  for (int band = 0; band < n_bands; ++band) {
    bool equal = true;
    for (int r = 0; r < n_rows; ++r) {
      if (a[band * n_rows + r] != b[band * n_rows + r]) {
        equal = false;
        break;
      }
    }
    if (equal) return true;
  }
  return false;
}

__device__ double hll_union_card(const uint8_t* a, const uint8_t* b) {
  double sum = 0.0;
  int zeros = 0;
  for (int j = 0; j < kM; ++j) {
    const int r = max((int)a[j], (int)b[j]);
    sum += ldexp(1.0, -r);
    if (r == 0) ++zeros;
  }
  const double m = kM;
  const double alpha = 0.7213 / (1.0 + 1.079 / m);
  const double raw = alpha * m * m / sum;
  const double two32 = 4294967296.0;
  if (raw < 2.5 * m && zeros > 0) return m * log(m / zeros);
  if (raw > two32 / 30.0) return -two32 * log1p(-raw / two32);
  return raw;
}

__global__ void kernel_CBsmh(const uint8_t* hll, const uint64_t* aux,
                             const double* cards, const int2* pairs,
                             long long n_pairs, double tau, int m_aux,
                             int n_rows, int n_bands, Result* out,
                             unsigned long long* out_count,
                             long long capacity) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pairs) return;
  const int2 pr = pairs[t];
  const int i = pr.x, k = pr.y;
  if (!smh_a(aux + (size_t)i * m_aux, aux + (size_t)k * m_aux, n_rows,
             n_bands))
    return;
  const double u = hll_union_card(hll + (size_t)i * kM, hll + (size_t)k * kM);
  const double sim = (cards[i] + cards[k] - u) / u;
  if (!isfinite(sim) || sim < tau) return;
  const unsigned long long slot = atomicAdd(out_count, 1ULL);
  if (slot < (unsigned long long)capacity)
    out[slot] = Result{i, k, (float)sim};
}

}  // namespace

// hll: uint8 (N, 2^14) rows sorted by cardinality; aux: uint64 (N, m_aux)
// SMH buckets in the same order; cards: f64 (N,); pairs: int2 (n_pairs,);
// out: capacity Results; out_count: one unsigned 64-bit counter, cleared
// here on the stream before the launch. block: threads a CTA (the
// reference's -b). Returns 0 or the launch's cudaError_t.
extern "C" int csc_reference_cbsmh(const void* hll, const void* aux,
                                   const void* cards, const void* pairs,
                                   long long n_pairs, double tau, int m_aux,
                                   int n_rows, int n_bands, void* out,
                                   void* out_count, long long capacity,
                                   int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out_count, 0, sizeof(unsigned long long),
                                    s);
  if (err != cudaSuccess) return (int)err;
  if (n_pairs > 0) {
    const long long grid = (n_pairs + block - 1) / block;
    kernel_CBsmh<<<(unsigned)grid, block, 0, s>>>(
        static_cast<const uint8_t*>(hll), static_cast<const uint64_t*>(aux),
        static_cast<const double*>(cards), static_cast<const int2*>(pairs),
        n_pairs, tau, m_aux, n_rows, n_bands, static_cast<Result*>(out),
        static_cast<unsigned long long*>(out_count), capacity);
  }
  return (int)cudaGetLastError();
}
