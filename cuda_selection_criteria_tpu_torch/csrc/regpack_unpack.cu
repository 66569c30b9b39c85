// Decode of the packed bank upload's bit-planes (ops/regpack.unpack_rows)
// for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's unpack_place
// (cuda_selection_criteria_tpu/ops/regpack.py:122), a jitted XLA decode
// into a donated buffer; not a Pallas kernel. Plain PyTorch version:
// ops/regpack.py:_unpack_rows_plain (the same shifts, masks and table
// take).
//
// What it computes: packed holds S rows of k bit-planes of R/8 bytes each
// ((S, k, R/8) uint8, C-contiguous); bit b of byte c of plane j is bit j
// of the value index of register 8c + b. For every register r of row s:
//   out[s, r] = table[sum_j bit (r mod 8) of packed[s, j, r / 8] << j],
// with out the S contiguous rows of R bytes at the caller's row i0 and
// table the 2^k index -> value map (k in 1..7, at most 128 values).
//
// Bound on the card: bytes. The planes are read once (S k R/8) and the
// registers written once (S R): a 128 MiB slab of registers at k = 6 is
// 96 MiB read and 128 MiB written, 0.070 ms at 3.35 TB/s. The arithmetic
// is a few integer operations a register, under the memory time.
//
// Design. One thread a group of 8 registers: byte c of each of the k
// planes of row s (a warp reads 32 neighbouring bytes of a plane, one
// sector; byte loads are never misaligned, whatever R/8 is, so an odd
// R/8 has no ragged end). Each plane byte spreads to bit 0 of 8 bytes by
// one multiply a nibble ((n * 0x00204081) & 0x01010101: the shifted
// copies do not overlap, so no carries), shifted to bit j and ORed into
// the group's 8 indices. The table sits in shared memory (at most 128
// bytes, one word a bank: a lookup never conflicts), and the 8 registers
// go out as one 8-byte store: a warp writes 256 contiguous bytes. Group
// g of the launch is row g / (R/8), byte g mod (R/8), and its registers
// are the 8-byte word g of out, since R = 8 R/8. A grid-stride loop, at
// most 16 CTAs an SM, walks the groups with the row and byte advanced
// by the stride's own quotient and remainder (no division in the loop).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 16;

// bit i of the low nibble -> bit 0 of byte i, for i < 4
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// bit i of the byte -> bit 0 of byte i of the word
__device__ __forceinline__ uint64_t spread8(uint32_t b) {
  return (uint64_t)spread4(b & 0xFu) |
         ((uint64_t)spread4((b >> 4) & 0xFu) << 32);
}

// grid (blocks,), block (kThreads,). out: S * r8 8-byte words, the
// destination rows; groups = S * r8.
__global__ void __launch_bounds__(kThreads)
regpack_unpack_kernel(const uint8_t* __restrict__ packed, long long groups,
                      long long r8, int k, const uint8_t* __restrict__ table,
                      uint64_t* __restrict__ out) {
  __shared__ uint8_t table_s[128];
  const int tid = threadIdx.x;
  if (tid < (1 << k)) table_s[tid] = table[tid];
  __syncthreads();

  const long long g0 = (long long)blockIdx.x * kThreads + tid;
  const long long stride = (long long)gridDim.x * kThreads;
  long long s = g0 / r8;  // the group's row and byte
  long long c = g0 - s * r8;
  const long long ds = stride / r8;
  const long long dc = stride - ds * r8;
  for (long long g = g0; g < groups; g += stride) {
    const uint8_t* src = packed + s * (long long)k * r8 + c;
    uint64_t idx = 0;
    for (int j = 0; j < k; ++j) idx |= spread8(__ldcs(src + j * r8)) << j;
    uint64_t w = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      w |= (uint64_t)table_s[(idx >> (8 * b)) & 0x7Fu] << (8 * b);
    out[g] = w;
    s += ds;
    c += dc;
    if (c >= r8) {
      c -= r8;
      ++s;
    }
  }
}

}  // namespace

// Launches the decode of s rows of k planes of r8 bytes at `packed` into
// the s * 8 * r8 bytes at `out` (8-byte aligned: the caller's row i0 of a
// contiguous bank) through the 2^k-byte `table`, on `stream`; returns the
// cudaError_t of the launch. Nothing is allocated here.
extern "C" int csc_regpack_unpack(const void* packed, long long s,
                                  long long r8, int k, const void* table,
                                  void* out, void* stream) {
  if (k < 1 || k > 7 || s < 0 || r8 < 0)
    return (int)cudaErrorInvalidValue;
  const long long groups = s * r8;
  if (groups == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (groups + kThreads - 1) / kThreads;
  const unsigned blocks =
      (unsigned)std::min(want, (long long)sms * kBlocksPerSM);
  regpack_unpack_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), groups, r8, k,
      static_cast<const uint8_t*>(table), static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}
