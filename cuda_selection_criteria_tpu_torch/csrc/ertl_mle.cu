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
// Bound on the card: the histograms' q + 2 bins read once and the
// estimates written once at 3.35 TB/s, against the f64 operations the
// rows' secant loops need at the 34 TFLOP/s of FP64 outside the tensor
// cores (chip_smoke.py counts them with the plain version's work
// counter). Counted so, the bytes bind: 0.034 ms against 0.004 ms for
// 524,288 rows of the bench bank (0.0075 ms with each __ddiv_rn at the 9
// FP64 instructions of its SASS). The kernel is bound by neither. Its loop
// alone, on rows that need no load, takes about 0.047 ms on those rows
// however many warps run it (24 or 32 an SM): dependent division chains,
// and lanes that wait for the warp's longest row. Its staging alone
// streams the rows at about 2.4 TB/s (0.053 ms; row_hist's 256-byte rows
// are read whole at the DRAM's 64-byte grain). The two overlap only in
// part: even with a warp's copies and its loop made independent of each
// other they take 0.075 ms together (cuda_selection_criteria_tpu_torch/
// experiments/mle_split.py times each part alone and together). So the
// design keeps every load of a warp in flight at once and as many warps
// resident as the registers allow, so that some warps stream while the
// others run their loops.
//
// Design: one thread a row, every row on its own loop, in groups of 32
// rows that one warp stages and then computes:
//  - A CTA is kWarps = 2 warps that share nothing: each stages its own
//    group into its own part of the CTA's shared memory and waits only for
//    its own copies, so there is no CTA barrier. The CTAs are persistent:
//    the grid is the batch's CTAs of groups or the SMs times the CTAs that
//    stay resident (16 an SM at p = 14: 32 warps, the registers' limit at
//    64 a thread), whichever is smaller, and warp w takes groups w, w + W,
//    ... (W the grid's warps). A small batch spreads over every SM (the 16k
//    bank's 512 groups over all 132); a large one keeps 32 warps an SM
//    busy with no tail of whole waves.
//  - Every staging load of a group is in flight before the first one is
//    waited on: each lane issues its 4-byte cp.async copies (bins lane and
//    lane + 32 of each of the group's rows: a warp instruction reads one
//    row's 128 contiguous bytes), then waits for them all. The serial
//    design before it copied each bin with a load that the next
//    iteration's store waited on, about 52 loads in turn a thread before
//    the first secant step.
//  - One group a warp, not two: double-buffering a warp's groups overlaps
//    its copies with its own loop but halves the resident warps (16 an
//    SM), whose loop alone then takes 0.055 ms where 32 warps take 0.047.
//    A producer warp a CTA filling a ring of groups for 8 consumer warps
//    was 3% faster at 524,288 rows and 20% slower at 16,384, and
//    prefetching the next group into L2 made every layout slower
//    (mle_split.py: variants w1b2, ws8, w2b1_pf).
//  - A staged row sits at an odd stride of (q + 2) | 1 words: the 32 lanes
//    that read c[row][k] for one k, and the copies of one instruction, hit
//    32 different banks. A 1-D bulk copy (TMA) would need the source's
//    contiguous 256-byte rows, so a stride of 64 words and a 32-way bank
//    conflict on every read of the loop; 16-byte copies need a stride of a
//    multiple of 4 words (a 4-way conflict at best). The 4-byte copies need
//    no alignment beyond the element's, so the fast route takes every
//    int32 and float32 input: row_hist's (N, 64) histograms, the dense
//    engine's contiguous (..., q + 2) unions and slices of a wider last
//    dimension at any row stride and base offset. The copies move the raw
//    bits; int32 bins are converted to float in place after the wait, each
//    lane the words it copied (exact up to 2^24, as the plain version holds
//    them in f32).
//  - int64 histograms (which no caller on the main path holds) take the
//    plain route: each lane loads its two bins of 8 rows at a time into
//    registers, converts and stores them.
//  - Each thread then runs its own row's secant loop to its own h_hi; the
//    plain version starts every row's inner loop at the batch's largest
//    h_hi, which changes nothing for the rows below it. Threads of a warp
//    diverge where their rows need other step counts: the same rows sorted
//    by their step count run 13% to 20% faster (mle_split.py,
//    sorted_steps), but no row's step count is known before it is staged,
//    and sorting within a CTA would cost a pass over its rows and a CTA
//    barrier.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 32;      // rows a group, one a lane
constexpr int kWarps = 2;      // warps a CTA, each on its own groups
constexpr int kMinCtas = 16;   // CTAs an SM that the registers must allow
constexpr int kPow2Lim = 120;  // the plain version's power-of-two range
// A row that has not converged after this many secant steps stops (the
// plain version would loop for ever); no histogram of counts reaches it.
constexpr int kMaxSteps = 1 << 12;

// Shared words a staged row: its q + 2 bins, made odd so that 32 rows at
// this stride fall in 32 different banks.
__host__ __device__ constexpr int row_words(int p) { return (66 - p) | 1; }

// Shared bytes a CTA: one group's rows a warp.
__host__ __device__ constexpr int cta_smem_bytes(int p) {
  return kWarps * kRows * row_words(p) * (int)sizeof(float);
}

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

// The MLE of one staged row c[0..q+1] (float bins); *log1p is set where the
// secant start took the log1p branch.
template <typename T>
__device__ __forceinline__ T row_mle(const float* c, int p, T eps,
                                     bool* log1p) {
  using R = Rn<T>;
  const int q = 64 - p;
  const int nb = q + 2;
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
  *log1p = !secant;
  return is_inf ? (T)INFINITY : R::mul(x, m);
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// The fast route's copies of `rows` rows at g (row stride `stride`
// elements) into s (row stride ss words), then the wait for all of them:
// lane l copies bins l and l + 32 (q + 2 >= 42 > 32 bins, so every lane
// has a first bin). Raw bits: int32 bins are converted after the wait.
template <typename Tin>
__device__ __forceinline__ void stage_async(const Tin* g, long long stride,
                                            int rows, int nb, int ss,
                                            float* s, int lane) {
  const bool hi = lane + 32 < nb;
  const Tin* src = g + lane;
  float* dst = s + lane;
  for (int r = 0; r < rows; ++r) {
    cp_async4(dst, src);
    if (hi) cp_async4(dst + 32, src + 32);
    src += stride;
    dst += ss;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// After the wait: the int32 bits this lane copied, as float, in place.
__device__ __forceinline__ void int_bits_to_float(int rows, int nb, int ss,
                                                  float* s, int lane) {
  const bool hi = lane + 32 < nb;
  float* d = s + lane;
  for (int r = 0; r < rows; ++r) {
    d[0] = (float)__float_as_int(d[0]);
    if (hi) d[32] = (float)__float_as_int(d[32]);
    d += ss;
  }
}

// The plain route (int64): lane l loads bins l and l + 32 of 8 rows at a
// time into registers, then converts and stores them.
template <typename Tin>
__device__ __forceinline__ void stage_sync(const Tin* g, long long stride,
                                           int rows, int nb, int ss, float* s,
                                           int lane) {
  const bool hi = lane + 32 < nb;
  for (int r0 = 0; r0 < rows; r0 += 8) {
    Tin lo_v[8], hi_v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = r0 + j < rows;
      const Tin* row = g + (long long)(r0 + j) * stride + lane;
      lo_v[j] = ok ? row[0] : (Tin)0;
      hi_v[j] = ok && hi ? row[32] : (Tin)0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r0 + j < rows) {
        float* d = s + (r0 + j) * ss + lane;
        d[0] = (float)lo_v[j];
        if (hi) d[32] = (float)hi_v[j];
      }
    }
  }
}

// Whether Tin takes the fast route (4-byte cp.async copies).
template <typename Tin>
__host__ __device__ constexpr bool async_route() {
  return sizeof(Tin) == 4;
}

template <typename Tin, typename T>
__global__ void __launch_bounds__(kWarps * kRows, kMinCtas)
    ertl_mle_kernel(const Tin* __restrict__ counts, long long n_rows,
                    long long stride, int p, T eps, T* __restrict__ est,
                    uint8_t* __restrict__ branch) {
  extern __shared__ float c_s[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = 66 - p;
  const int ss = row_words(p);
  const long long n_groups = (n_rows + kRows - 1) / kRows;
  const long long n_warps = (long long)gridDim.x * kWarps;
  float* buf = c_s + warp * kRows * ss;
  for (long long grp = (long long)blockIdx.x * kWarps + warp; grp < n_groups;
       grp += n_warps) {
    const int rows = (int)min((long long)kRows, n_rows - grp * kRows);
    const Tin* g = counts + grp * kRows * stride;
    if constexpr (async_route<Tin>()) {
      stage_async(g, stride, rows, nb, ss, buf, lane);
      if constexpr (std::is_same<Tin, int32_t>::value)
        int_bits_to_float(rows, nb, ss, buf, lane);
    } else {
      stage_sync(g, stride, rows, nb, ss, buf, lane);
    }
    __syncwarp();
    if (lane < rows) {
      const long long row = grp * kRows + lane;
      bool log1p;
      est[row] = row_mle<T>(buf + lane * ss, p, eps, &log1p);
      if (branch != nullptr) branch[row] = log1p ? 1 : 0;
    }
    __syncwarp();  // every lane is done with buf before it is restaged
  }
}

// CTAs of kernel `kern` that stay resident on an SM at `smem` bytes, asked
// once a (device, p) after setting the carveout to the most shared memory
// (16 CTAs of 13,568 bytes and 1 KB reserved each fill the SM's 228 KB).
template <typename K>
int resident_ctas(K kern, int p, int smem, int dev) {
  static int cache[16][25];  // 0: not asked yet
  int* slot = dev >= 0 && dev < 16 ? &cache[dev][p] : nullptr;
  if (slot != nullptr && *slot > 0) return *slot;
  cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kWarps * kRows,
                                                    smem) != cudaSuccess ||
      n < 1)
    n = 1;
  if (slot != nullptr) *slot = n;
  return n;
}

// The persistent grid for n_rows rows: min(CTAs of kWarps groups,
// SMs x resident CTAs).
template <typename K>
cudaError_t grid_for(K kern, long long n_rows, int p, unsigned* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long ctas =
      ((n_rows + kRows - 1) / kRows + kWarps - 1) / kWarps;
  const long long cap =
      (long long)sms * resident_ctas(kern, p, cta_smem_bytes(p), dev);
  *grid = (unsigned)(ctas < cap ? ctas : cap);
  return cudaSuccess;
}

template <typename Tin, typename T>
cudaError_t launch_t(const void* counts, long long n_rows, long long stride,
                     int p, T eps, void* est, void* branch, cudaStream_t st) {
  auto kern = ertl_mle_kernel<Tin, T>;
  unsigned grid = 0;
  cudaError_t err = grid_for(kern, n_rows, p, &grid);
  if (err != cudaSuccess) return err;
  kern<<<grid, kWarps * kRows, cta_smem_bytes(p), st>>>(
      static_cast<const Tin*>(counts), n_rows, stride, p, eps,
      static_cast<T*>(est), static_cast<uint8_t*>(branch));
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_in(const void* counts, long long n_rows, long long stride,
                      int p, int f64, double eps, void* est, void* branch,
                      cudaStream_t st) {
  if (f64)
    return launch_t<Tin, double>(counts, n_rows, stride, p, eps, est, branch,
                                 st);
  return launch_t<Tin, float>(counts, n_rows, stride, p, (float)eps, est,
                              branch, st);
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
