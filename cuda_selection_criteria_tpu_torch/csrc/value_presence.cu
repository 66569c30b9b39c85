// Present register values of a uint8 bank (ops/screen.bank_values) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's bank_values
// (cuda_selection_criteria_tpu/ops/screen.py:185), whose one pass over the
// bank is the native host scan fastx_value_presence
// (cuda_selection_criteria_tpu/native/fastx.cpp:461); not a Pallas kernel.
// Plain PyTorch version: ops/screen.py:_bank_values_plain (a chunked
// torch.bincount).
//
// What it computes: the 256-bit presence mask of the bytes of n contiguous
// bytes: bit b of word w is set when some byte equals 32w + b. The plan
// reads the mask back (32 bytes) and turns it into the sorted tuple of
// present values, one telescope bin each.
//
// Bound on the card: one read of the n bytes at the card's memory rate
// (8 GiB, smh_a-524k's bank: 2.56 ms at 3.35 TB/s); the mask is nothing.
// The work per byte is a compare and a shift: at about six integer
// operations a byte the CUDA cores stay under the memory time, so the
// design only has to keep enough loads in flight.
//
// Design. One pass, one launch:
//  1. A grid-stride loop of 16-byte streaming loads, four in flight a
//     thread, over the 16-byte aligned middle of the bytes; the unaligned
//     head and the ragged tail (< 32 bytes in all) go one byte a thread.
//  2. Values below 64 set bits of a 64-bit register mask of the thread. A
//     32-bit word whose four bytes are all below 64 (HLL registers at
//     p = 14 are at most 51, at p_aux = 8 at most 57) takes four shifts
//     and no branch; a word with a byte of 64 or more goes byte by byte,
//     and those bytes set their bit in shared memory with atomicOr, after
//     a read that skips the atomic when the bit is already set. Exact for
//     any bytes, slow only for banks full of large values.
//  3. The register masks meet in a warp OR (__reduce_or_sync on each
//     32-bit half), one shared atomicOr a warp, then one global atomicOr a
//     block for each non-zero word of the block's 8; the caller zeroes the
//     8 words on the stream before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ void add_byte(uint32_t b, uint64_t& lo,
                                         uint32_t* hi_s) {
  if (b < 64) {
    lo |= 1ull << b;
  } else {
    const uint32_t bit = 1u << (b & 31);
    if (!(hi_s[b >> 5] & bit)) atomicOr(&hi_s[b >> 5], bit);
  }
}

__device__ __forceinline__ void add_word(uint32_t x, uint64_t& lo,
                                         uint32_t* hi_s) {
  if ((x & 0xC0C0C0C0u) == 0u) {  // every byte below 64
    lo |= (1ull << (x & 0xFFu)) | (1ull << ((x >> 8) & 0xFFu)) |
          (1ull << ((x >> 16) & 0xFFu)) | (1ull << (x >> 24));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) add_byte((x >> (8 * k)) & 0xFFu, lo, hi_s);
  }
}

// grid (blocks,), block (kThreads,); mask: 8 uint32 words, zeroed.
__global__ void __launch_bounds__(kThreads)
value_presence_kernel(const uint8_t* __restrict__ x, long long n,
                      int head, uint32_t* __restrict__ mask) {
  __shared__ uint32_t mask_s[8];
  const int tid = threadIdx.x;
  if (tid < 8) mask_s[tid] = 0u;
  __syncthreads();

  const long long gid = (long long)blockIdx.x * kThreads + tid;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nvec = (n - head) / 16;
  const long long tail0 = head + nvec * 16;
  const uint4* v = reinterpret_cast<const uint4*>(x + head);
  uint64_t lo = 0;
  for (long long i = gid; i < nvec; i += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      // past the end, vector i again: a repeat adds nothing to the mask
      q[u] = __ldcs(v + (j < nvec ? j : i));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add_word(q[u].x, lo, mask_s);
      add_word(q[u].y, lo, mask_s);
      add_word(q[u].z, lo, mask_s);
      add_word(q[u].w, lo, mask_s);
    }
  }
  // the head before the first aligned vector and the tail after the last
  const long long n_scalar = head + (n - tail0);
  if (gid < n_scalar) add_byte(x[gid < head ? gid : tail0 + (gid - head)],
                               lo, mask_s);

  const uint32_t w0 = __reduce_or_sync(0xffffffffu, (uint32_t)lo);
  const uint32_t w1 = __reduce_or_sync(0xffffffffu, (uint32_t)(lo >> 32));
  if ((tid & 31) == 0) {
    if (w0) atomicOr(&mask_s[0], w0);
    if (w1) atomicOr(&mask_s[1], w1);
  }
  __syncthreads();
  if (tid < 8 && mask_s[tid]) atomicOr(&mask[tid], mask_s[tid]);
}

}  // namespace

// Launches the presence scan of the n bytes at x on `stream` into `mask`
// (8 uint32 words, zeroed by the caller on the same stream); returns the
// cudaError_t of the launch. n <= 0 launches nothing. Nothing is
// allocated here.
extern "C" int csc_value_presence(const void* x, long long n, void* mask,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const int head = (int)std::min((long long)((16 - (addr & 15)) & 15), n);
  const long long nvec = (n - head) / 16;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // enough threads for the vectors (kUnroll each) and for the < 32 scalar
  // bytes, at most kBlocksPerSM blocks an SM
  const long long per_block = (long long)kThreads * kUnroll;
  const long long want = std::max((nvec + per_block - 1) / per_block, 1ll);
  const unsigned blocks =
      (unsigned)std::min(want, (long long)sms * kBlocksPerSM);
  value_presence_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(x), n, head, static_cast<uint32_t*>(mask));
  return (int)cudaGetLastError();
}
