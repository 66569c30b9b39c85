// Timing probes of the row-histogram kernel (csrc/row_hist.cu) for
// experiments/hist_split.py: the kernel as it is, the mask-walk design it
// replaced, the other counter layouts and updates tried for it, and two
// probes: the kernel without its end-of-row sums, and its loads alone.
// Every other variant computes the histograms and the present-value mask
// of the kernel.
//
// It includes the kernel's source, so the library also exports
// csc_row_hist. The straight-line variants repeat the kernel's row loop
// (its loads, head and tail, and end of row): edit both together.

#include "../csrc/row_hist.cu"

namespace hs {

constexpr uint32_t kFull = 0xffffffffu;
constexpr int kU = 4;             // 16-byte loads a lane a batch
constexpr int kBlocksPerSM = 6;   // CTAs an SM, every variant

// ---------------------------------------------------------------------
// The mask-walk design (the kernel before its redesign), as it was: one
// warp a row, eight rows a CTA, a 16-bit mask of each vector's non-zero
// bytes walked with __ffs, each byte a shared load, add and store on the
// lane's 16-bit half (word (v >> 1) * 32 + lane, half v & 1), the words
// cleared at the end of each row.
constexpr int kOldWarps = 8;

__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

__device__ __forceinline__ uint32_t byte_bits(uint32_t nz) {
  return (((nz >> 7) * 0x01020408u) >> 24) & 0xFu;
}

__device__ __forceinline__ void old_add_value(uint32_t b, uint32_t* sub,
                                              uint32_t& big,
                                              uint32_t* mask_s) {
  if (b < 64u) {
    sub[(b >> 1) * 32] += 1u << ((b & 1u) * 16);
  } else {
    ++big;
    atomicOr(&mask_s[b >> 5], 1u << (b & 31u));
  }
}

__device__ __forceinline__ void old_add_vector(const uint4& q, uint32_t* sub,
                                               uint32_t& big,
                                               uint32_t* mask_s) {
  uint32_t m = byte_bits(nonzero_bytes(q.x)) |
               (byte_bits(nonzero_bytes(q.y)) << 4) |
               (byte_bits(nonzero_bytes(q.z)) << 8) |
               (byte_bits(nonzero_bytes(q.w)) << 12);
  const uint64_t lo = ((uint64_t)q.y << 32) | q.x;
  const uint64_t hi = ((uint64_t)q.w << 32) | q.z;
  while (m) {
    const int i = __ffs(m) - 1;
    m &= m - 1;
    old_add_value((uint32_t)((i < 8 ? lo : hi) >> ((i & 7) * 8)) & 0xFFu,
                  sub, big, mask_s);
  }
}

__device__ __forceinline__ void maskwalk_body(const uint8_t* __restrict__ x,
                                              long long n_rows, int R,
                                              int* __restrict__ hist,
                                              uint32_t* __restrict__ mask) {
  __shared__ uint32_t sub_s[kOldWarps * 32 * 32];
  __shared__ uint32_t mask_s[8];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t* words = sub_s + (tid >> 5) * 32 * 32;
  uint32_t* sub = words + lane;
#pragma unroll
  for (int b = 0; b < 32; ++b) sub[b * 32] = 0u;
  if (tid < 8) mask_s[tid] = 0u;
  __syncthreads();

  uint64_t present = 0;
  const long long stride = (long long)gridDim.x * kOldWarps;
  for (long long row = (long long)blockIdx.x * kOldWarps + (tid >> 5);
       row < n_rows; row += stride) {
    const uint8_t* rp = x + row * R;
    const int mis = (16 - (int)(reinterpret_cast<uintptr_t>(rp) & 15)) & 15;
    const int head = mis < R ? mis : R;
    const int nvec = (R - head) / 16;
    const int tail0 = head + nvec * 16;
    const uint4* v = reinterpret_cast<const uint4*>(rp + head);
    uint32_t big = 0;
    for (int i = lane; i < nvec; i += 32 * kU) {
      uint4 q[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = i + u * 32;
        q[u] = j < nvec ? __ldcs(v + j) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) old_add_vector(q[u], sub, big, mask_s);
    }
    if (lane < head + (R - tail0)) {
      const uint32_t b = rp[lane < head ? lane : tail0 + (lane - head)];
      if (b) old_add_value(b, sub, big, mask_s);
    }
    __syncwarp();
    uint32_t c0 = 0, c1 = 0;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      uint32_t* w = words + lane * 32 + ((k + lane) & 31);
      const uint32_t c = *w;
      *w = 0u;
      c0 += c & 0xFFFFu;
      c1 += c >> 16;
    }
    const uint32_t counted = __reduce_add_sync(kFull, c0 + c1 + big);
    if (lane == 0) c0 = (uint32_t)R - counted;
    *reinterpret_cast<int2*>(hist + row * 64 + 2 * lane) =
        make_int2((int)c0, (int)c1);
    present |= ((uint64_t)(c0 > 0) << (2 * lane)) |
               ((uint64_t)(c1 > 0) << (2 * lane + 1));
    __syncwarp();
  }

  const uint32_t w0 = __reduce_or_sync(kFull, (uint32_t)present);
  const uint32_t w1 = __reduce_or_sync(kFull, (uint32_t)(present >> 32));
  if (lane == 0) {
    if (w0) atomicOr(&mask_s[0], w0);
    if (w1) atomicOr(&mask_s[1], w1);
  }
  __syncthreads();
  if (tid < 8 && mask_s[tid]) atomicOr(&mask[tid], mask_s[tid]);
}

// ---------------------------------------------------------------------
// Straight-line candidates: every byte taken from its word without a walk,
// counted on one of two counter layouts by one of two updates.
//   kHalves: the mask-walk design's 16-bit halves (4 KiB a warp, eight
//            warps a CTA), cleared at the end of each row;
//   else     32-bit counters, value-major (word v * 32 + lane, 8 KiB a
//            warp, four warps a CTA), never cleared: a row's counts are the
//            difference of the lanes' sums, as in the kernel.
//   kAtomic: a shared reduction (red.shared.add.u32) whose result nothing
//            waits on; else a shared load, add and store.
//   kSkipZero: zero bytes are not counted (the test compiles to a branch
//            around each update) and bin 0 is R less the counted bytes;
//            else every byte is counted, bin 0 too (32-bit only), as in
//            the kernel.
//   kLop3:   (32-bit, atomic, zeros skipped) byte k of word w as
//            t = w & (0xff << 8k), one LOP3 that also tests t != 0, and
//            its counter at base + (t >> (8k - 7)), in place of __byte_perm.
//   kReduce: the end-of-row sums; without them (a probe) each lane writes
//            its value-0 word, so the row's bins are not its histogram.

template <bool kHalves, bool kAtomic>
__device__ __forceinline__ void bump(uint32_t* col, uint32_t col_a,
                                     uint32_t b) {
  const uint32_t off = kHalves ? (b >> 1) * 32 : b * 32;
  const uint32_t inc = kHalves ? 1u << ((b & 1u) * 16) : 1u;
  if (kAtomic) {
    asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(col_a + off * 4),
                 "r"(inc)
                 : "memory");
  } else {
    col[off] += inc;
  }
}

__device__ __forceinline__ void red_at(uint32_t a) {
  asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(a), "r"(1u) : "memory");
}

template <bool kHalves, bool kAtomic, bool kSkipZero>
__device__ __forceinline__ uint32_t cand_byte(uint32_t b, uint32_t* col,
                                              uint32_t col_a,
                                              uint32_t* mask_s) {
  if (b >= 64u) {
    atomicOr(&mask_s[b >> 5], 1u << (b & 31u));
    return 1u;
  }
  if (!kSkipZero || b) bump<kHalves, kAtomic>(col, col_a, b);
  return 0u;
}

template <bool kHalves, bool kAtomic, bool kSkipZero>
__device__ __noinline__ uint32_t cand_slow(uint4 q, uint32_t* col,
                                           uint32_t col_a,
                                           uint32_t* mask_s) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  uint32_t big = 0;
  for (int i = 0; i < 16; ++i)
    big += cand_byte<kHalves, kAtomic, kSkipZero>(
        (w[i >> 2] >> ((i & 3) * 8)) & 0xFFu, col, col_a, mask_s);
  return big;
}

template <bool kHalves, bool kAtomic, bool kSkipZero, bool kLop3>
__device__ __forceinline__ uint32_t cand_vector(const uint4& q,
                                                uint32_t* col,
                                                uint32_t col_a,
                                                uint32_t* mask_s) {
  if ((q.x | q.y | q.z | q.w) & 0xC0C0C0C0u)
    return cand_slow<kHalves, kAtomic, kSkipZero>(q, col, col_a, mask_s);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  if (kLop3) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t t0 = w[k] & 0xFFu, t1 = w[k] & 0xFF00u,
                     t2 = w[k] & 0xFF0000u, t3 = w[k] & 0xFF000000u;
      if (t0) red_at(col_a + (t0 << 7));
      if (t1) red_at(col_a + (t1 >> 1));
      if (t2) red_at(col_a + (t2 >> 9));
      if (t3) red_at(col_a + (t3 >> 17));
    }
    return 0u;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t b = __byte_perm(w[i >> 2], 0u, 0x4440u | (i & 3));
    if (!kSkipZero || b) bump<kHalves, kAtomic>(col, col_a, b);
  }
  return 0u;
}

template <bool kHalves, bool kAtomic, bool kSkipZero, int kW, bool kLop3,
          bool kReduce>
__device__ __forceinline__ void cand_body(const uint8_t* __restrict__ x,
                                          long long n_rows, int R,
                                          int* __restrict__ hist,
                                          uint32_t* __restrict__ mask) {
  constexpr int kWords = kHalves ? 32 * 32 : 64 * 32;
  __shared__ uint32_t cnt_s[kW * kWords];
  __shared__ uint32_t mask_s[8];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t* words = cnt_s + (tid >> 5) * kWords;
  uint32_t* col = words + lane;
#pragma unroll
  for (int v = 0; v < kWords / 32; ++v) col[v * 32] = 0u;
  if (tid < 8) mask_s[tid] = 0u;
  __syncthreads();
  const uint32_t col_a = static_cast<uint32_t>(__cvta_generic_to_shared(col));

  uint64_t present = 0;
  uint32_t sum0 = 0, sum1 = 0;
  const long long stride = (long long)gridDim.x * kW;
  for (long long row = (long long)blockIdx.x * kW + (tid >> 5);
       row < n_rows; row += stride) {
    const uint8_t* rp = x + row * R;
    const int mis = (16 - (int)(reinterpret_cast<uintptr_t>(rp) & 15)) & 15;
    const int head = mis < R ? mis : R;
    const int nvec = (R - head) / 16;
    const int tail0 = head + nvec * 16;
    const uint4* v = reinterpret_cast<const uint4*>(rp + head);
    uint32_t big = 0;
    uint4 q[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = lane + u * 32;
      q[u] = j < nvec ? __ldcs(v + j) : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = lane; i < nvec; i += 32 * kU) {
      uint4 nx[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = i + (kU + u) * 32;
        nx[u] = j < nvec ? __ldcs(v + j) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        // with every byte counted, a vector past the row must not be
        if (kSkipZero || i + u * 32 < nvec)
          big += cand_vector<kHalves, kAtomic, kSkipZero, kLop3>(
              q[u], col, col_a, mask_s);
        q[u] = nx[u];
      }
    }
    if (lane < head + (R - tail0))
      big += cand_byte<kHalves, kAtomic, kSkipZero>(
          rp[lane < head ? lane : tail0 + (lane - head)], col, col_a,
          mask_s);
    __syncwarp();
    uint32_t c0 = 0, c1 = 0;
    if (kHalves) {
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        uint32_t* w = words + lane * 32 + ((k + lane) & 31);
        const uint32_t c = *w;
        *w = 0u;
        c0 += c & 0xFFFFu;
        c1 += c >> 16;
      }
    } else if (!kReduce) {
      c0 = words[lane];
    } else {
      uint32_t s0 = 0, s1 = 0;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const int l = (k + lane) & 31;
        s0 += words[(2 * lane) * 32 + l];
        s1 += words[(2 * lane + 1) * 32 + l];
      }
      c0 = s0 - sum0;
      c1 = s1 - sum1;
      sum0 = s0;
      sum1 = s1;
    }
    const uint32_t counted = __reduce_add_sync(kFull, c0 + c1 + big);
    if (kSkipZero && lane == 0) c0 = (uint32_t)R - counted;
    *reinterpret_cast<int2*>(hist + row * 64 + 2 * lane) =
        make_int2((int)c0, (int)c1);
    present |= ((uint64_t)(c0 > 0) << (2 * lane)) |
               ((uint64_t)(c1 > 0) << (2 * lane + 1));
    __syncwarp();
  }

  const uint32_t w0 = __reduce_or_sync(kFull, (uint32_t)present);
  const uint32_t w1 = __reduce_or_sync(kFull, (uint32_t)(present >> 32));
  if (lane == 0) {
    if (w0) atomicOr(&mask_s[0], w0);
    if (w1) atomicOr(&mask_s[1], w1);
  }
  __syncthreads();
  if (tid < 8 && mask_s[tid]) atomicOr(&mask[tid], mask_s[tid]);
}

// The loads alone: the kernel's reads of every row (its batches, head and
// tail), each lane's bytes folded into one word by xor, written where the
// lane's two bins go, so the histograms' bytes are written too.
__device__ __forceinline__ void loads_body(const uint8_t* __restrict__ x,
                                           long long n_rows, int R,
                                           int* __restrict__ hist,
                                           uint32_t* __restrict__ mask) {
  constexpr int kW = 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long stride = (long long)gridDim.x * kW;
  for (long long row = (long long)blockIdx.x * kW + (tid >> 5);
       row < n_rows; row += stride) {
    const uint8_t* rp = x + row * R;
    const int mis = (16 - (int)(reinterpret_cast<uintptr_t>(rp) & 15)) & 15;
    const int head = mis < R ? mis : R;
    const int nvec = (R - head) / 16;
    const int tail0 = head + nvec * 16;
    const uint4* v = reinterpret_cast<const uint4*>(rp + head);
    uint32_t acc = 0;
    uint4 q[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = lane + u * 32;
      q[u] = j < nvec ? __ldcs(v + j) : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = lane; i < nvec; i += 32 * kU) {
      uint4 nx[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = i + (kU + u) * 32;
        nx[u] = j < nvec ? __ldcs(v + j) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        acc ^= q[u].x ^ q[u].y ^ q[u].z ^ q[u].w;
        q[u] = nx[u];
      }
    }
    if (lane < head + (R - tail0))
      acc ^= rp[lane < head ? lane : tail0 + (lane - head)];
    *reinterpret_cast<int2*>(hist + row * 64 + 2 * lane) =
        make_int2((int)acc, 0);
  }
  if (blockIdx.x == 0 && tid < 8) mask[tid] = 0u;
}

}  // namespace hs

#define HS_CANDIDATE(name, halves, atomic, skip, warps, lop3, reduce)       \
  extern "C" __global__ void __launch_bounds__((warps) * 32)               \
      name(const uint8_t* __restrict__ x, long long n_rows, int R,         \
           int* __restrict__ hist, uint32_t* __restrict__ mask) {          \
    hs::cand_body<halves, atomic, skip, warps, lop3, reduce>(x, n_rows, R, \
                                                             hist, mask);  \
  }

HS_CANDIDATE(hs_line16, true, false, true, 8, false, true)
HS_CANDIDATE(hs_red16, true, true, true, 8, false, true)
HS_CANDIDATE(hs_line32, false, false, true, 4, false, true)
HS_CANDIDATE(hs_line32_all, false, false, false, 4, false, true)
HS_CANDIDATE(hs_red32, false, true, true, 4, false, true)
HS_CANDIDATE(hs_red32_lop3, false, true, true, 4, true, true)
HS_CANDIDATE(hs_no_reduce, false, true, false, 4, false, false)

extern "C" __global__ void __launch_bounds__(hs::kOldWarps * 32)
hs_maskwalk(const uint8_t* __restrict__ x, long long n_rows, int R,
            int* __restrict__ hist, uint32_t* __restrict__ mask) {
  hs::maskwalk_body(x, n_rows, R, hist, mask);
}

extern "C" __global__ void __launch_bounds__(128)
hs_loads(const uint8_t* __restrict__ x, long long n_rows, int R,
         int* __restrict__ hist, uint32_t* __restrict__ mask) {
  hs::loads_body(x, n_rows, R, hist, mask);
}

namespace {

typedef void (*HsKernel)(const uint8_t*, long long, int, int*, uint32_t*);

// variant ids of experiments/hist_split.py: 0 is csc_row_hist
struct HsVariant {
  HsKernel fn;
  int warps;
  bool carveout;  // all of the SM's shared memory to shared
};

const HsVariant kHsVariants[] = {
    {nullptr, 0, false},      // 0: the kernel, csc_row_hist
    {hs_maskwalk, 8, false},  // 1: the design it replaced, as it launched
    {hs_line16, 8, true},     // 2
    {hs_red16, 8, true},      // 3
    {hs_line32, 4, true},     // 4
    {hs_line32_all, 4, true}, // 5
    {hs_red32, 4, true},      // 6
    {hs_red32_lop3, 4, true}, // 7
    {hs_no_reduce, 4, true},  // 8
    {hs_loads, 4, true},      // 9
};

}  // namespace

// Launches variant `variant` reps times back to back on `stream` over the
// n_rows x R bytes at x: hist (n_rows x 64 int32) and mask (8 words; the
// caller zeroes it before a launch whose mask it reads). Returns the first
// cudaError_t that is not cudaSuccess.
extern "C" int hist_split_run(int variant, const void* x, long long n_rows,
                              int R, void* hist, void* mask, int reps,
                              void* stream) {
  const int n_variants = (int)(sizeof(kHsVariants) / sizeof(kHsVariants[0]));
  if (variant < 0 || variant >= n_variants || n_rows <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HsVariant& var = kHsVariants[variant];
  if (var.fn == nullptr) {
    for (int r = 0; r < reps; ++r) {
      const int err = csc_row_hist(x, n_rows, R, hist, mask, stream);
      if (err != 0) return err;
    }
    return (int)cudaSuccess;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && var.carveout)
    err = cudaFuncSetAttribute(var.fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n_rows + var.warps - 1) / var.warps;
  const unsigned blocks =
      (unsigned)std::min(want, (long long)sms * hs::kBlocksPerSM);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  int* hp = static_cast<int*>(hist);
  uint32_t* mp = static_cast<uint32_t*>(mask);
  void* args[] = {&xp, &n_rows, &R, &hp, &mp};
  for (int r = 0; r < reps; ++r) {
    err = cudaLaunchKernel(reinterpret_cast<const void*>(var.fn),
                           dim3(blocks), dim3(var.warps * 32), args, 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// CTAs an SM that each variant can hold, as the runtime computes them
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) after its carveout is
// set as its launch sets it; -1 on an error.
extern "C" int hist_split_occupancy(int variant) {
  const int n_variants = (int)(sizeof(kHsVariants) / sizeof(kHsVariants[0]));
  if (variant < 0 || variant >= n_variants) return -1;
  const HsVariant& var = kHsVariants[variant];
  HsKernel fn = variant == 0 ? row_hist_kernel : var.fn;
  const int threads = variant == 0 ? kThreads : var.warps * 32;
  if ((variant == 0 || var.carveout) &&
      cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0) !=
      cudaSuccess)
    return -1;
  return blocks;
}
