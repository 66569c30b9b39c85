// Register histograms of every row of a uint8 bank (ops/screen.row_hist)
// for NVIDIA Hopper (sm_90a).
//
// Replaces the histogram half of the JAX package's
// SketchBank.compute_cards (cuda_selection_criteria_tpu/models/bank.py:97-103,
// a host np.bincount of row * 64 + reg on an accelerator;
// ops/estimators.py:64 hll_histogram on the CPU backend); not a Pallas
// kernel. Plain PyTorch version: ops/screen.py:_row_hist_plain (a
// torch.bincount of row * 64 + reg over row chunks). The f64 MLE that
// turns the histograms into cardinalities stays on the host
// (models/bank.mle_rows).
//
// What it computes, in one pass over the n x R bytes:
//   hist[i, v] = #{r : regs[i, r] == v}  for v < 64 (int32, exact), and
//   the 256-bit present-value mask of csrc/value_presence.cu over the same
//   bytes (bit b of word w set when some byte equals 32w + b). Words 2..7
//   of the mask are the error word: a register of 64 or more sets one, and
//   the wrapper raises on it (such a byte has no bin of its own).
//
// Bound on the card: the bytes read once and the histograms written once,
// N * R + N * 256 bytes at the card's memory rate (2 GiB of registers:
// 0.651 ms at 3.35 TB/s).
//
// Design. A real genome's row at p=14 has no zero byte, so what a byte
// costs sets the time: walked one non-zero byte at a time, with a shared
// load, add and store that the next byte's load waits on, it costs 35
// instructions and the kernel a quarter of its bound. Here every byte,
// zeros included, costs three instructions with nothing waited on (5.3 a
// byte in the row loop with its loads), and the loads bind
// (experiments/hist_split.py times the alternatives):
//  1. One warp a row, four rows (warps) a CTA, rows strided over a grid of
//     at most kBlocksPerSM CTAs an SM. A lane reads the row's 16-byte
//     aligned middle as 16-byte streaming loads, neighbouring lanes on
//     neighbouring vectors, two batches of kUnroll vectors in flight (the
//     next batch is loaded before the current one is counted); the
//     unaligned head and the ragged tail (< 32 bytes) go one byte a lane.
//  2. A lane owns one 32-bit counter a value in shared memory, value-major:
//     value v of lane l at word v * 32 + l of its warp's 8 KiB, so the
//     lanes of a warp hit 32 different banks whatever their values. Each
//     byte of a vector is taken from its word by one PRMT (__byte_perm),
//     its counter's address is one IMAD (base + 128 * byte), and one
//     red.shared.add.u32 of 1 counts it, with no result to wait for, so no
//     byte waits on its neighbour. Zero bytes are counted like the others:
//     a predicate to skip them compiles to a branch around the reduction,
//     which costs more than the reduction on the bench banks' rows.
//  3. A vector with a byte of 64 or more (an error: the wrapper raises)
//     leaves the straight line for count_slow, out of line, which counts
//     its bytes below 64 and sets the mask bits of the others with a
//     shared atomicOr.
//  4. The counters are never cleared: at the end of a row lane b sums the
//     words of values 2b and 2b + 1 over the 32 lanes (word v * 32 +
//     (k + b) % 32 at step k, conflict free) and takes this row's counts
//     as the difference from its sums at the end of the warp's previous
//     row, exact modulo 2^32 since a row holds fewer than 2^31 bytes. Each
//     lane writes its two bins as one 8-byte store, a row's 256 bytes in
//     one coalesced store.
//  5. The present values below 64 are the bins > 0, ORed over the warp's
//     rows in a register, then over the CTA in shared memory, then one
//     global atomicOr a block and non-zero word; the caller zeroes the 8
//     words on the stream first.
// Rows of up to 2^31 - 1 bytes (R is an int) need no other limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 4;  // rows in flight a CTA, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // 16-byte loads a lane a batch, two batches
constexpr int kWarpWords = 64 * 32;  // a warp's counters, 8 KiB
// 32 KiB of counters a CTA: six CTAs (24 warps) fill an SM's 228 KiB
constexpr int kBlocksPerSM = 6;
constexpr uint32_t kFull = 0xffffffffu;

// One shared reduction of 1 on the 32-bit counter at shared address a.
__device__ __forceinline__ void red_one(uint32_t a) {
  asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(a), "r"(1u) : "memory");
}

// A byte b of the head or tail, or of a vector with a byte of 64 or more;
// the lane's value-0 counter lies at shared address col.
__device__ __forceinline__ void count_byte(uint32_t b, uint32_t col,
                                           uint32_t* mask_s) {
  if (b < 64u)
    red_one(col + b * 128u);
  else
    atomicOr(&mask_s[b >> 5], 1u << (b & 31u));
}

// The vectors with a byte of 64 or more, out of line, so that the
// straight line's loop holds only its own instructions.
__device__ __noinline__ void count_slow(uint4 q, uint32_t col,
                                        uint32_t* mask_s) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  for (int i = 0; i < 16; ++i)
    count_byte((w[i >> 2] >> ((i & 3) * 8)) & 0xFFu, col, mask_s);
}

__device__ __forceinline__ void count_vector(const uint4& q, uint32_t col,
                                             uint32_t* mask_s) {
  if ((q.x | q.y | q.z | q.w) & 0xC0C0C0C0u) {
    count_slow(q, col, mask_s);
    return;
  }
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    red_one(col + __byte_perm(w[i >> 2], 0u, 0x4440u | (i & 3)) * 128u);
}

// grid (blocks,), block (kThreads,); hist (n_rows, 64) int32, mask 8 uint32
// words, zeroed.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
row_hist_kernel(const uint8_t* __restrict__ x, long long n_rows, int R,
                int* __restrict__ hist, uint32_t* __restrict__ mask) {
  // word v * 32 + l of a warp's slice: lane l's count of value v over the
  // warp's rows so far, modulo 2^32
  __shared__ uint32_t cnt_s[kWarps * kWarpWords];
  __shared__ uint32_t mask_s[8];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t* words = cnt_s + (tid >> 5) * kWarpWords;
#pragma unroll
  for (int v = 0; v < 64; ++v) words[v * 32 + lane] = 0u;
  if (tid < 8) mask_s[tid] = 0u;
  __syncthreads();
  const uint32_t col =
      static_cast<uint32_t>(__cvta_generic_to_shared(words + lane));

  uint64_t present = 0;    // values below 64 in this lane's bins so far
  uint32_t sum0 = 0, sum1 = 0;  // values 2 lane and 2 lane + 1, all rows
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (tid >> 5);
       row < n_rows; row += stride) {
    const uint8_t* rp = x + row * R;
    const int mis = (16 - (int)(reinterpret_cast<uintptr_t>(rp) & 15)) & 15;
    const int head = mis < R ? mis : R;
    const int nvec = (R - head) / 16;
    const int tail0 = head + nvec * 16;
    const uint4* v = reinterpret_cast<const uint4*>(rp + head);
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = lane + u * 32;
      q[u] = j < nvec ? __ldcs(v + j) : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = lane; i < nvec; i += 32 * kUnroll) {
      uint4 nx[kUnroll];  // the next batch, in flight while q is counted
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = i + (kUnroll + u) * 32;
        nx[u] = j < nvec ? __ldcs(v + j) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u * 32 < nvec) count_vector(q[u], col, mask_s);
        q[u] = nx[u];
      }
    }
    // the head before the first aligned vector and the tail after the last
    if (lane < head + (R - tail0))
      count_byte(rp[lane < head ? lane : tail0 + (lane - head)], col,
                 mask_s);
    __syncwarp();
    uint32_t s0 = 0, s1 = 0;  // lanes' counts of values 2 lane, + 1
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      const int l = (k + lane) & 31;
      s0 += words[(2 * lane) * 32 + l];
      s1 += words[(2 * lane + 1) * 32 + l];
    }
    const uint32_t c0 = s0 - sum0, c1 = s1 - sum1;
    sum0 = s0;
    sum1 = s1;
    *reinterpret_cast<int2*>(hist + row * 64 + 2 * lane) =
        make_int2((int)c0, (int)c1);
    present |= ((uint64_t)(c0 > 0) << (2 * lane)) |
               ((uint64_t)(c1 > 0) << (2 * lane + 1));
    __syncwarp();  // every lane has read the words before the next row
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

}  // namespace

// Launches the histogram pass over the n_rows x R bytes at x on `stream`:
// hist (n_rows x 64 int32, every entry written) and mask (8 uint32 words,
// zeroed by the caller on the same stream). Returns the cudaError_t of the
// launch; n_rows or R of 0 launches nothing, below 0 is
// cudaErrorInvalidValue (an R of 2^31 or more, cut to an int). A row's
// counts are exact for every R an int holds. Nothing is allocated here.
extern "C" int csc_row_hist(const void* x, long long n_rows, int R,
                            void* hist, void* mask, void* stream) {
  if (n_rows < 0 || R < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // all of the SM's shared memory to shared, so six CTAs fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(row_hist_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n_rows + kWarps - 1) / kWarps;
  const unsigned blocks =
      (unsigned)std::min(want, (long long)sms * kBlocksPerSM);
  row_hist_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(x), n_rows, R, static_cast<int*>(hist),
      static_cast<uint32_t*>(mask));
  return (int)cudaGetLastError();
}
