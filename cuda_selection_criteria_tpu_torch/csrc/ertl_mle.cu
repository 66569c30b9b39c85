// Ertl's maximum-likelihood HLL cardinality estimate (ops/estimators.
// ertl_mle) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's jitted estimators.ertl_mle
// (cuda_selection_criteria_tpu/ops/estimators.py:78), which is not a
// Pallas kernel: an XLA while loop over a batch. It is the device branch of
// SketchBank.compute_cards (models/bank.py:80-104: the bank's
// cardinalities) and the dense engines' union MLE (ops/pairwise.py:100,
// ops/criteria.py:90 and :107, parallel/mesh.py:79 and :104). Plain PyTorch
// version: cuda_selection_criteria_tpu_torch/ops/estimators.py:
// _ertl_mle_plain (the batched masked loop, one torch op a multiply or an
// add).
//
// What it computes, for each histogram row c[0..q+1] (q = 64 - p, m = 2^p):
// Ertl's Algorithm 8 (the reference's hll.h:629-688) as the plain version
// computes it, in the compute type T (double or float): the secant start,
// the log1p branch when g0 > 1.5 a, the secant loop while
// deltaX > x * eps, with the inner h / x' loop from min(64, h_hi) down to 1,
// and inf where c[q+1] == m. Every operation is one explicit round-to-
// nearest intrinsic (__dadd_rn, __dmul_rn, __ddiv_rn; __fadd_rn, __fmul_rn,
// __fdiv_rn; a - b is a + (-b), the same bits), so ptxas never contracts a
// multiply and an add into an FMA: each result is the plain version's, op
// for op. Scaling by 2^e multiplies by an exact power of two built from its
// bits, with e clamped to [-120, 120] as the plain version's table is;
// frexp is exact. The log1p start calls CUDA's log1p / log1pf, the function
// torch's CUDA log1p calls. Besides the estimates it writes one byte a row,
// 1 where the secant start took the log1p branch: there CUDA's, glibc's
// and SLEEF's log1p differ by an ulp, so the bank's exact cardinalities
// recompute those rows on the host (models/bank.cards_from_hists).
//
// Bound on the card: the f64 operations the rows' secant loops need, at
// the 34 TFLOP/s of FP64 outside the tensor cores, against the histograms
// read once and the estimates written once at 3.35 TB/s; which binds
// depends on the rows' iterations (chip_smoke.py counts them with the plain
// version's work counter). A division is counted as one operation though
// the card has no divide unit, so the bound is loose on the operations
// side.
//
// Design: one thread a row, every row on its own loop. The rows are
// independent and their loops short (a few secant steps of at most 64 inner
// steps), so nothing is shared between threads but the staging:
//  - A CTA of kThreads threads takes kThreads consecutive rows. Their
//    q + 2 bins are copied into shared memory as float (the plain version
//    holds the histograms in f32 too: exact for counts <= 2^24), thread i
//    copying elements i, i + kThreads, ... of the block's rows, so
//    neighbouring threads read neighbouring bins of a row (int32, int64 or
//    float rows at any row stride: row_hist's (N, 64) int32 histograms,
//    the dense engine's f32 (..., q + 2) ones or a slice of them).
//  - A row sits at a stride of kStride = 65 words: when the threads of a
//    warp read c[row][k] for the same k they hit 32 different banks.
//  - Each thread then runs its own row's secant loop to its own h_hi; the
//    plain version starts every row's inner loop at the batch's largest
//    h_hi, which changes nothing for the rows below it. Threads of a warp
//    diverge where their rows need other step counts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // rows a CTA, one a thread
constexpr int kStride = 65;    // shared words a row: 64 bins and a pad word
constexpr int kPow2Lim = 120;  // the plain version's power-of-two range
// A row that has not converged after this many secant steps stops (the
// plain version would loop for ever); no histogram of counts reaches it.
constexpr int kMaxSteps = 1 << 12;

template <typename T>
struct Rn;

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dadd_rn(a, -b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double log1p_(double a) {
    return log1p(a);
  }
  // 2^e, exact, for |e| <= kPow2Lim
  static __device__ __forceinline__ double pow2(int e) {
    return __longlong_as_double((long long)(e + 1023) << 52);
  }
  static __device__ __forceinline__ int exponent(double x) {
    int e;
    frexp(x, &e);
    return e;
  }
};

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fadd_rn(a, -b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float log1p_(float a) { return log1pf(a); }
  static __device__ __forceinline__ float pow2(int e) {
    return __int_as_float((e + 127) << 23);
  }
  static __device__ __forceinline__ int exponent(float x) {
    int e;
    frexpf(x, &e);
    return e;
  }
};

// x * 2^e with e clamped as the plain version's power-of-two table is
template <typename T>
__device__ __forceinline__ T ldexp_clamped(T x, int e) {
  return Rn<T>::mul(x, Rn<T>::pow2(max(-kPow2Lim, min(kPow2Lim, e))));
}

template <typename Tin, typename T>
__global__ void __launch_bounds__(kThreads)
    ertl_mle_kernel(const Tin* __restrict__ counts, long long n_rows,
                    long long stride, int p, T eps, T* __restrict__ est,
                    uint8_t* __restrict__ branch) {
  using R = Rn<T>;
  __shared__ float c_s[kThreads * kStride];
  const int q = 64 - p;
  const int nb = q + 2;
  const long long r0 = (long long)blockIdx.x * kThreads;
  const int rows = (int)min((long long)kThreads, n_rows - r0);
  for (int i = threadIdx.x; i < rows * nb; i += kThreads) {
    const int r = i / nb;
    const int k = i - r * nb;
    c_s[r * kStride + k] = (float)counts[(r0 + r) * stride + k];
  }
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const float* c = c_s + threadIdx.x * kStride;
  const long long row = r0 + threadIdx.x;

  const float mf = (float)(1 << p);
  const T m = (T)mf;
  const bool is_inf = c[q + 1] == mf;
  int k_min = -1, k_max = 0;
  for (int k = 0; k < nb; ++k) {
    if (c[k] > 0.0f) {
      if (k_min < 0) k_min = k;
      k_max = k;
    }
  }
  const int k_min_p = max(k_min, 1);  // an empty row has k_min 0
  const int k_max_p = min(k_max, q);

  // z = sum_{k = kMinP..kMaxP} c[k] 2^-k, high to low (hll.h:671-673)
  T z = 0;
  for (int k = k_max_p; k >= k_min_p; --k) {
    z = R::add(R::mul((T)0.5, z), (T)c[k]);
  }
  z = ldexp_clamped(z, -k_min_p);
  const T c_prime = R::add((T)c[q + 1], (T)c[k_max_p]);
  const T a = R::add(z, (T)c[0]);
  const T m_prime = R::sub(m, (T)c[0]);
  const T g0 = R::add(z, R::mul((T)c[q + 1], R::pow2(-q)));
  const bool secant = g0 <= R::mul((T)1.5, a);
  T x = secant ? R::div(m_prime, R::add(R::mul((T)0.5, g0), a))
               : R::mul(R::div(m_prime, g0), R::log1p_(R::div(g0, a)));
  T delta_x = x;
  T g_prev = 0;
  const T c45 = (T)(1.0 / 45.0);

  for (int step_no = 0; step_no < kMaxSteps; ++step_no) {
    if (!(delta_x > R::mul(x, eps))) break;
    const int kappa_m1 = x > (T)0 ? R::exponent(x) : 0;
    const int h_hi = max(kappa_m1, k_max_p - 1);
    T xp = ldexp_clamped(x, -max(k_max_p + 1, kappa_m1 + 2));
    const T xpp = R::mul(xp, xp);
    T h = R::add(R::sub(xp, R::div(xpp, (T)3.0)),
                 R::mul(R::mul(xpp, xpp), R::sub(c45, R::div(xpp, (T)472.5))));
    // h / x' updates for k in [kMinP, h_hi] descending; g seeded with
    // cPrime * h at k = kMaxP - 1 before that step's update, then c[k] * h
    // added for k <= kMaxP - 1 (hll.h:667-680)
    T g = 0;
    for (int k = min(64, h_hi); k >= 1; --k) {
      if (k == k_max_p - 1) g = R::mul(c_prime, h);
      if (k >= k_min_p) {
        const T hp = R::sub((T)1.0, h);
        h = R::div(R::add(xp, R::mul(h, hp)), R::add(xp, hp));
        xp = R::add(xp, xp);
        if (k <= k_max_p - 1) g = R::add(g, R::mul((T)c[k], h));
      }
    }
    if (k_max_p <= 1) g = R::mul(c_prime, h);
    g = R::add(g, R::mul(x, a));
    // deltaX *= (g - mPrime) / (gprev - g), the division first (hll.h:683)
    const T step = (g_prev < g && g <= m_prime)
                       ? R::mul(delta_x, R::div(R::sub(g, m_prime),
                                                R::sub(g_prev, g)))
                       : (T)0;
    x = R::add(x, step);
    delta_x = step;
    g_prev = g;
  }
  est[row] = is_inf ? (T)INFINITY : R::mul(x, m);
  if (branch != nullptr) branch[row] = secant ? 0 : 1;
}

template <typename Tin>
cudaError_t launch_in(const void* counts, long long n_rows, long long stride,
                      int p, int f64, double eps, void* est, void* branch,
                      cudaStream_t st) {
  const unsigned blocks = (unsigned)((n_rows + kThreads - 1) / kThreads);
  const Tin* in = static_cast<const Tin*>(counts);
  uint8_t* br = static_cast<uint8_t*>(branch);
  if (f64) {
    ertl_mle_kernel<Tin, double><<<blocks, kThreads, 0, st>>>(
        in, n_rows, stride, p, eps, static_cast<double*>(est), br);
  } else {
    ertl_mle_kernel<Tin, float><<<blocks, kThreads, 0, st>>>(
        in, n_rows, stride, p, (float)eps, static_cast<float*>(est), br);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches the MLE over n_rows histogram rows at `counts` (element type
// in_kind: 0 int32, 1 int64, 2 float), row r's bins 0..q+1 at
// counts + r * stride elements, on `stream`: est (n_rows doubles when f64,
// else floats) and, unless branch is null, branch (n_rows bytes, 1 where
// the secant start took the log1p branch). eps is relerr / sqrt(m) in the
// compute type, computed by the caller. Returns the cudaError_t of the
// launch; n_rows <= 0 launches nothing. Needs 2 <= p <= 24 (q + 2 <= 64
// bins; counts <= 2^p exact in float). Nothing is allocated here.
extern "C" int csc_ertl_mle(const void* counts, int in_kind, long long n_rows,
                            long long stride, int p, int f64, double eps,
                            void* est, void* branch, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  if (p < 2 || p > 24 || stride < 66 - p) return (int)cudaErrorInvalidValue;
  if ((n_rows + kThreads - 1) / kThreads >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_kind) {
    case 0:
      return (int)launch_in<int32_t>(counts, n_rows, stride, p, f64, eps,
                                     est, branch, st);
    case 1:
      return (int)launch_in<long long>(counts, n_rows, stride, p, f64, eps,
                                       est, branch, st);
    case 2:
      return (int)launch_in<float>(counts, n_rows, stride, p, f64, eps, est,
                                   branch, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
