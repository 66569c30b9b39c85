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
// N * R + N * 256 bytes at the card's memory rate (smh_a-524k's 8 GiB bank:
// 2.60 ms at 3.35 TB/s).
//
// Design. HLL rows are skewed: at 2048 hashes in 16,384 registers about 88%
// of the bytes are 0, so shared atomics on one bin would serialize. Counts
// are kept private instead, and the zeros are not counted at all:
//  1. One warp a row, eight rows (warps) a CTA, rows strided over a grid of
//     at most kBlocksPerSM CTAs an SM. A lane reads the row's 16-byte
//     aligned middle as 16-byte streaming loads, kUnroll in flight,
//     neighbouring lanes on neighbouring vectors; the unaligned head and the
//     ragged tail (< 32 bytes) go one byte a lane.
//  2. Each 16-byte vector becomes a 16-bit mask of its non-zero bytes
//     (SWAR: bit 7 of ((x & 0x7f..) + 0x7f..) | x, no carry crossing a
//     byte), and the lane visits only those bytes. A value v < 64 adds one
//     to the lane's own 16-bit counter, half v & 1 of shared word
//     (v >> 1) * 32 + lane of the warp's 4 KiB: the lanes of a warp always
//     hit 32 different banks, whatever the values, and no atomic is needed.
//     A value of 64 or more is counted apart and sets its mask bit with a
//     shared atomicOr (an error, so rare).
//  3. At the end of a row lane b sums the two counters of values 2b and
//     2b + 1 over the 32 lanes (reading word b * 32 + (k + b) % 32, conflict
//     free) and zeroes each word it read, ready for the next row; bin 0 is
//     R less every byte counted. Each lane writes its two bins as one 8-byte
//     store, a row's 256 bytes in one coalesced store.
//  4. The present values below 64 are the bins > 0, ORed over the warp's
//     rows in a register, then over the CTA in shared memory, then one
//     global atomicOr a block and non-zero word; the caller zeroes the 8
//     words on the stream first.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;  // rows in flight a CTA, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight a lane
constexpr int kBlocksPerSM = 6;
constexpr uint32_t kFull = 0xffffffffu;

// bit 7 of each byte set when the byte is non-zero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// bit 7 of byte b -> bit b (the bits 0, 8, 16, 24 times 0x01020408)
__device__ __forceinline__ uint32_t byte_bits(uint32_t nz) {
  return (((nz >> 7) * 0x01020408u) >> 24) & 0xFu;
}

// Adds byte value b to the lane's counters `sub` (its column of the warp's
// words) or, at 64 and above, to `big` and the shared mask.
__device__ __forceinline__ void add_value(uint32_t b, uint32_t* sub,
                                          uint32_t& big, uint32_t* mask_s) {
  if (b < 64u) {
    sub[(b >> 1) * 32] += 1u << ((b & 1u) * 16);
  } else {
    ++big;
    atomicOr(&mask_s[b >> 5], 1u << (b & 31u));
  }
}

__device__ __forceinline__ void add_vector(const uint4& q, uint32_t* sub,
                                           uint32_t& big, uint32_t* mask_s) {
  uint32_t m = byte_bits(nonzero_bytes(q.x)) |
               (byte_bits(nonzero_bytes(q.y)) << 4) |
               (byte_bits(nonzero_bytes(q.z)) << 8) |
               (byte_bits(nonzero_bytes(q.w)) << 12);
  const uint64_t lo = ((uint64_t)q.y << 32) | q.x;
  const uint64_t hi = ((uint64_t)q.w << 32) | q.z;
  while (m) {
    const int i = __ffs(m) - 1;
    m &= m - 1;
    add_value((uint32_t)((i < 8 ? lo : hi) >> ((i & 7) * 8)) & 0xFFu, sub,
              big, mask_s);
  }
}

// grid (blocks,), block (kThreads,); hist (n_rows, 64) int32, mask 8 uint32
// words, zeroed.
__global__ void __launch_bounds__(kThreads)
row_hist_kernel(const uint8_t* __restrict__ x, long long n_rows, int R,
                int* __restrict__ hist, uint32_t* __restrict__ mask) {
  // word b * 32 + l of a warp's slice: lane l's counts of values 2b (low
  // half) and 2b + 1 (high half) in the current row
  __shared__ uint32_t sub_s[kWarps * 32 * 32];
  __shared__ uint32_t mask_s[8];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t* words = sub_s + (tid >> 5) * 32 * 32;
  uint32_t* sub = words + lane;
#pragma unroll
  for (int b = 0; b < 32; ++b) sub[b * 32] = 0u;
  if (tid < 8) mask_s[tid] = 0u;
  __syncthreads();

  uint64_t present = 0;  // values below 64 in this lane's bins so far
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (tid >> 5);
       row < n_rows; row += stride) {
    const uint8_t* rp = x + row * R;
    const int mis = (16 - (int)(reinterpret_cast<uintptr_t>(rp) & 15)) & 15;
    const int head = mis < R ? mis : R;
    const int nvec = (R - head) / 16;
    const int tail0 = head + nvec * 16;
    const uint4* v = reinterpret_cast<const uint4*>(rp + head);
    uint32_t big = 0;  // this lane's bytes of 64 or more
    for (int i = lane; i < nvec; i += 32 * kUnroll) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = i + u * 32;
        q[u] = j < nvec ? __ldcs(v + j) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_vector(q[u], sub, big, mask_s);
    }
    // the head before the first aligned vector and the tail after the last
    if (lane < head + (R - tail0)) {
      const uint32_t b = rp[lane < head ? lane : tail0 + (lane - head)];
      if (b) add_value(b, sub, big, mask_s);
    }
    __syncwarp();
    uint32_t c0 = 0, c1 = 0;  // this row's counts of values 2 lane, +1
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      uint32_t* w = words + lane * 32 + ((k + lane) & 31);
      const uint32_t c = *w;
      *w = 0u;
      c0 += c & 0xFFFFu;
      c1 += c >> 16;
    }
    const uint32_t counted = __reduce_add_sync(kFull, c0 + c1 + big);
    if (lane == 0) c0 = (uint32_t)R - counted;  // zeros were not counted
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

}  // namespace

// Launches the histogram pass over the n_rows x R bytes at x on `stream`:
// hist (n_rows x 64 int32, every entry written) and mask (8 uint32 words,
// zeroed by the caller on the same stream). Returns the cudaError_t of the
// launch; n_rows <= 0 or R <= 0 launches nothing. A lane's 16-bit counters
// hold at most R / 32 + 17 counts, so R must stay below 2^21. Nothing is
// allocated here.
extern "C" int csc_row_hist(const void* x, long long n_rows, int R,
                            void* hist, void* mask, void* stream) {
  if (n_rows <= 0 || R <= 0) return (int)cudaSuccess;
  if (R >= (1 << 21)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n_rows + kWarps - 1) / kWarps;
  const unsigned blocks =
      (unsigned)std::min(want, (long long)sms * kBlocksPerSM);
  row_hist_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(x), n_rows, R, static_cast<int*>(hist),
      static_cast<uint32_t*>(mask));
  return (int)cudaGetLastError();
}
