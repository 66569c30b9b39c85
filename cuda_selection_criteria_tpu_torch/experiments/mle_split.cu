// Timing probes of the ERTL-MLE kernel (csrc/ertl_mle.cu) for
// experiments/mle_split.py: the kernel as it is, the serial-staging design
// it replaced, each design with a part taken out, and the other layouts
// tried for it. The kernel, the serial design and the other layouts
// (w1b2, w2b1_pf, ws8) compute the estimates; the staging-alone and
// loop-alone variants are timing probes.
//
// It includes the kernel's source, so every variant runs the kernel's own
// per-row loop (row_mle), and the library also exports csc_ertl_mle. The
// group loop of the layout probes repeats ertl_mle_kernel's: edit both
// together.

#include "../csrc/ertl_mle.cu"

namespace {

// The serial design: a CTA of 128 threads takes 128 consecutive rows, one
// a thread, and stages them at a 65-word stride, thread i copying elements
// i, i + 128, ... of the block's rows with one load a copy, each load
// waited on by the store after it.
constexpr int kOldThreads = 128;
constexpr int kOldStride = 65;

enum Mode {
  kFull = 0,   // staging and loop
  kStage = 1,  // staging alone: a checksum of each staged row is written
  kLoop = 2,   // loop alone: every row is `row`, copied from one 64-float
               // row that all lanes read at the same address
  kIndep = 3,  // both, independent: the copies of each group land in one
               // buffer while the loop runs on `row` in the other
};

template <typename T>
__device__ __forceinline__ T checksum(const float* c, int nb) {
  T sum = 0;
  for (int k = 0; k < nb; ++k) sum += (T)c[k];
  return sum;
}

template <typename Tin, typename T, int kMode>
__global__ void __launch_bounds__(kOldThreads)
    serial_kernel(const Tin* __restrict__ counts, long long n_rows,
                  long long stride, int p, T eps, T* __restrict__ est,
                  uint8_t* __restrict__ branch,
                  const float* __restrict__ row) {
  __shared__ float c_s[kOldThreads * kOldStride];
  const int nb = 66 - p;
  const long long r0 = (long long)blockIdx.x * kOldThreads;
  const int rows = (int)min((long long)kOldThreads, n_rows - r0);
  if (kMode == kLoop) {
    for (int k = 0; k < nb; ++k)
      c_s[threadIdx.x * kOldStride + k] = __ldg(row + k);
  } else {
    for (int i = threadIdx.x; i < rows * nb; i += kOldThreads) {
      const int r = i / nb;
      const int k = i - r * nb;
      c_s[r * kOldStride + k] = (float)counts[(r0 + r) * stride + k];
    }
  }
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const float* c = c_s + threadIdx.x * kOldStride;
  const long long r = r0 + threadIdx.x;
  if (kMode == kStage) {
    est[r] = checksum<T>(c, nb);
    return;
  }
  bool log1p;
  est[r] = row_mle<T>(c, p, eps, &log1p);
  if (branch != nullptr) branch[r] = log1p ? 1 : 0;
}

// stage_async's copies without its wait, committed as one cp.async group.
template <typename Tin>
__device__ __forceinline__ void issue_copies(const Tin* g, long long stride,
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
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One bulk L2 prefetch of a group's rows when their span is at most twice
// the bins they hold (else nothing).
template <typename Tin>
__device__ __forceinline__ void prefetch_group(const Tin* counts,
                                               long long stride, long long g,
                                               int rows, int nb) {
  if (stride > 2 * nb) return;
  const Tin* first = counts + g * kRows * stride;
  const unsigned long long lo = (unsigned long long)first;
  const unsigned long long hi =
      (unsigned long long)(first + (long long)(rows - 1) * stride + nb);
  const unsigned long long a = (lo + 15) & ~15ull;
  const unsigned long long b = hi & ~15ull;
  if (b > a)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(a),
                 "r"((unsigned)(b - a))
                 : "memory");
}

// Layouts: kW independent warps a CTA, kBufs groups a warp in shared
// memory (1: stage, wait, compute, as ertl_mle_kernel; 2: the next group's
// copies in flight while the current one computes), with kPf lane 0
// prefetching the warp's next group into L2 before the loop. kMode as
// above; kIndep needs kBufs 2.
template <typename Tin, typename T, int kMode, int kW, int kBufs, bool kPf>
__global__ void __launch_bounds__(32 * kW, (kBufs == 2 ? 16 : 32) / kW)
    layout_kernel(const Tin* __restrict__ counts, long long n_rows,
                  long long stride, int p, T eps, T* __restrict__ est,
                  uint8_t* __restrict__ branch,
                  const float* __restrict__ row) {
  extern __shared__ float c_s[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = 66 - p;
  const int ss = row_words(p);
  const long long n_groups = (n_rows + kRows - 1) / kRows;
  const long long n_warps = (long long)gridDim.x * kW;
  long long grp = (long long)blockIdx.x * kW + warp;
  if (grp >= n_groups) return;
  float* cur = c_s + warp * kBufs * kRows * ss;
  float* nxt = cur + (kBufs == 2 ? kRows * ss : 0);
  auto rows_of = [&](long long g) {
    return (int)min((long long)kRows, n_rows - g * kRows);
  };
  if (kBufs == 2 && (kMode == kFull || kMode == kStage))
    issue_copies(counts + grp * kRows * stride, stride, rows_of(grp), nb, ss,
                 cur, lane);
  if (kMode == kIndep)
    for (int k = 0; k < nb; ++k) cur[lane * ss + k] = __ldg(row + k);
  for (; grp < n_groups; grp += n_warps) {
    const int rows = rows_of(grp);
    const long long next = grp + n_warps;
    if (kMode == kIndep) {
      issue_copies(counts + grp * kRows * stride, stride, rows, nb, ss, nxt,
                   lane);
    } else if (kMode == kLoop) {
      for (int k = 0; k < nb; ++k) cur[lane * ss + k] = __ldg(row + k);
    } else {
      if (kBufs == 2) {
        if (next < n_groups) {
          issue_copies(counts + next * kRows * stride, stride, rows_of(next),
                       nb, ss, nxt, lane);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      } else {
        stage_async(counts + grp * kRows * stride, stride, rows, nb, ss, cur,
                    lane);
      }
      if (std::is_same<Tin, int32_t>::value)
        int_bits_to_float(rows, nb, ss, cur, lane);
    }
    __syncwarp();
    if (kPf && next < n_groups && lane == 0)
      prefetch_group(counts, stride, next, rows_of(next), nb);
    if (lane < rows) {
      const long long r = grp * kRows + lane;
      if (kMode == kStage) {
        est[r] = checksum<T>(cur + lane * ss, nb);
      } else {
        bool log1p;
        est[r] = row_mle<T>(cur + lane * ss, p, eps, &log1p);
        if (branch != nullptr) branch[r] = log1p ? 1 : 0;
      }
    }
    if (kMode == kIndep) cp_async_wait<0>();
    __syncwarp();
    if (kBufs == 2 && kMode != kIndep) {
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

template <typename Tin, typename T, int kMode, int kW, int kBufs, bool kPf>
cudaError_t launch_layout(const Tin* in, long long n_rows, long long stride,
                          int p, T eps, T* out, uint8_t* br, const float* row,
                          cudaStream_t st) {
  auto kern = layout_kernel<Tin, T, kMode, kW, kBufs, kPf>;
  const int smem = kW * kBufs * kRows * row_words(p) * 4;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * kW, smem);
  const long long ctas = ((n_rows + kRows - 1) / kRows + kW - 1) / kW;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(ctas < cap ? ctas : cap);
  kern<<<grid, 32 * kW, smem, st>>>(in, n_rows, stride, p, eps, out, br,
                                    row);
  return cudaGetLastError();
}

// Warp-specialized layout: one producer warp a CTA issues every copy
// (cp.async 4-byte, the odd-stride layout) into a ring of n_slots groups,
// and kCons consumer warps compute; full / empty mbarriers a slot. The
// producer's copies arrive on full[s] when they land
// (cp.async.mbarrier.arrive.noinc), a consumer releases empty[s] after
// its loop. Consumer w of CTA b takes tasks t = w, w + kCons, ...; task t
// is group (t / kCons) * grid * kCons + b * kCons + t % kCons, in slot
// t % n_slots. A consumer converts its own row's int32 bits.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* b,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(b))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred P1;\n"
      "LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared.b64 P1, [%0], %1;\n"
      " @P1 bra DONE;\n"
      " bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

constexpr int kMaxSlots = 12;

template <typename Tin, typename T, int kCons, int kMinB>
__global__ void __launch_bounds__(32 * (kCons + 1), kMinB)
    ws_kernel(const Tin* __restrict__ counts, long long n_rows,
              long long stride, int p, T eps, T* __restrict__ est,
              uint8_t* __restrict__ branch, int n_slots) {
  extern __shared__ float c_s[];
  __shared__ __align__(8) unsigned long long full[kMaxSlots];
  __shared__ __align__(8) unsigned long long empty[kMaxSlots];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = 66 - p;
  const int ss = row_words(p);
  const long long n_groups = (n_rows + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_slots; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 1);
    }
  }
  __syncthreads();
  const long long step = (long long)gridDim.x * kCons;
  auto group_of = [&](long long t) {
    return (t / kCons) * step + (long long)blockIdx.x * kCons + t % kCons;
  };
  if (warp == kCons) {  // the producer
    for (long long t = 0;; ++t) {
      const long long g = group_of(t);
      if (g >= n_groups) break;
      const int s = (int)(t % n_slots);
      const unsigned use = (unsigned)(t / n_slots);
      mbar_wait(&empty[s], (use & 1) ^ 1);
      const int rows = (int)min((long long)kRows, n_rows - g * kRows);
      float* buf = c_s + s * kRows * ss;
      const bool hi = lane + 32 < nb;
      const Tin* src = counts + g * kRows * stride + lane;
      float* dst = buf + lane;
      for (int r = 0; r < rows; ++r) {
        cp_async4(dst, src);
        if (hi) cp_async4(dst + 32, src + 32);
        src += stride;
        dst += ss;
      }
      mbar_arrive_copies(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  for (long long t = warp;; t += kCons) {  // a consumer
    const long long g = group_of(t);
    if (g >= n_groups) break;
    const int s = (int)(t % n_slots);
    const unsigned use = (unsigned)(t / n_slots);
    mbar_wait(&full[s], use & 1);
    const int rows = (int)min((long long)kRows, n_rows - g * kRows);
    float* c = c_s + s * kRows * ss + lane * ss;
    if (lane < rows) {
      if (std::is_same<Tin, int32_t>::value)
        for (int k = 0; k < nb; ++k) c[k] = (float)__float_as_int(c[k]);
      const long long r = g * kRows + lane;
      bool log1p;
      est[r] = row_mle<T>(c, p, eps, &log1p);
      if (branch != nullptr) branch[r] = log1p ? 1 : 0;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

template <typename Tin, typename T, int kCons, int kMinB>
cudaError_t launch_ws(const Tin* in, long long n_rows, long long stride,
                      int p, T eps, T* out, uint8_t* br, cudaStream_t st) {
  auto kern = ws_kernel<Tin, T, kCons, kMinB>;
  const int slot_bytes = kRows * row_words(p) * 4;
  const int fit = (233472 / kMinB - 1024 - 256) / slot_bytes;
  const int n_slots = fit < kMaxSlots ? fit : kMaxSlots;
  if (n_slots < kCons + 1) return cudaErrorInvalidValue;
  const int smem = n_slots * slot_bytes;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                32 * (kCons + 1), smem);
  const long long ctas = ((n_rows + kRows - 1) / kRows + kCons - 1) / kCons;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(ctas < cap ? ctas : cap);
  kern<<<grid, 32 * (kCons + 1), smem, st>>>(in, n_rows, stride, p, eps, out,
                                             br, n_slots);
  return cudaGetLastError();
}

template <typename Tin, typename T>
cudaError_t run_t(int variant, const void* counts, long long n_rows,
                  long long stride, int p, T eps, void* est, void* branch,
                  const float* row, cudaStream_t st) {
  const Tin* in = static_cast<const Tin*>(counts);
  T* out = static_cast<T*>(est);
  uint8_t* br = static_cast<uint8_t*>(branch);
  const unsigned old_grid =
      (unsigned)((n_rows + kOldThreads - 1) / kOldThreads);
  switch (variant) {
    case 0:
      return launch_t<Tin, T>(counts, n_rows, stride, p, eps, est, branch,
                              st);
    case 1:
      serial_kernel<Tin, T, kFull><<<old_grid, kOldThreads, 0, st>>>(
          in, n_rows, stride, p, eps, out, br, row);
      return cudaGetLastError();
    case 2:
      serial_kernel<Tin, T, kStage><<<old_grid, kOldThreads, 0, st>>>(
          in, n_rows, stride, p, eps, out, br, row);
      return cudaGetLastError();
    case 3:
      serial_kernel<Tin, T, kLoop><<<old_grid, kOldThreads, 0, st>>>(
          in, n_rows, stride, p, eps, out, br, row);
      return cudaGetLastError();
    case 4:
      return launch_layout<Tin, T, kStage, kWarps, 1, false>(
          in, n_rows, stride, p, eps, out, br, row, st);
    case 5:
      return launch_layout<Tin, T, kLoop, kWarps, 1, false>(
          in, n_rows, stride, p, eps, out, br, row, st);
    case 6:
      return launch_layout<Tin, T, kFull, 1, 2, false>(in, n_rows, stride, p,
                                                      eps, out, br, row, st);
    case 7:
      return launch_layout<Tin, T, kStage, 1, 2, false>(
          in, n_rows, stride, p, eps, out, br, row, st);
    case 8:
      return launch_layout<Tin, T, kLoop, 1, 2, false>(in, n_rows, stride, p,
                                                      eps, out, br, row, st);
    case 9:
      return launch_layout<Tin, T, kIndep, 1, 2, false>(
          in, n_rows, stride, p, eps, out, br, row, st);
    case 10:
      return launch_layout<Tin, T, kFull, kWarps, 1, true>(
          in, n_rows, stride, p, eps, out, br, row, st);
    case 11:
      return launch_ws<Tin, T, 8, 3>(in, n_rows, stride, p, eps, out, br, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches variant `variant` (mle_split.py's VARIANTS) `reps` times back
// to back on `stream` over the int32 (in_kind 0) or float32 (2)
// histograms, the arguments as csc_ertl_mle's; `row` is a device pointer
// to 64 floats, the row that the loop-alone variants compute. Returns the
// first cudaError_t that is not cudaSuccess.
extern "C" int mle_split_run(int variant, const void* counts, int in_kind,
                             long long n_rows, long long stride, int p,
                             int f64, double eps, void* est, void* branch,
                             const float* row, int reps, void* stream) {
  if (n_rows <= 0 || p < 2 || p > 24 || stride < 66 - p)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < reps; ++i) {
    cudaError_t err;
    if (in_kind == 0 && f64)
      err = run_t<int32_t, double>(variant, counts, n_rows, stride, p, eps,
                                   est, branch, row, st);
    else if (in_kind == 0)
      err = run_t<int32_t, float>(variant, counts, n_rows, stride, p,
                                  (float)eps, est, branch, row, st);
    else if (in_kind == 2 && f64)
      err = run_t<float, double>(variant, counts, n_rows, stride, p, eps,
                                 est, branch, row, st);
    else if (in_kind == 2)
      err = run_t<float, float>(variant, counts, n_rows, stride, p,
                                (float)eps, est, branch, row, st);
    else
      err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// One division each, never launched: mle_split.py counts the instructions
// of __ddiv_rn and __fdiv_rn in their SASS (cuobjdump -sass).
extern "C" __global__ void mle_split_div_f64(const double* a,
                                             const double* b, double* o) {
  o[threadIdx.x] = __ddiv_rn(a[threadIdx.x], b[threadIdx.x]);
}

extern "C" __global__ void mle_split_div_f32(const float* a, const float* b,
                                             float* o) {
  o[threadIdx.x] = __fdiv_rn(a[threadIdx.x], b[threadIdx.x]);
}
