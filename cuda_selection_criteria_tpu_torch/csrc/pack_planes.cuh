// The pack stage shared by the port's bit-plane CDF kernels for NVIDIA
// Hopper (sm_90a): K1 (screen_fused.cu) and K2 (weighted_cdf_sum.cu).
//
// [max(a, b) <= v] == [a <= v] & [b <= v], so the pack stage turns every
// bank row into K-1 bit-planes of R/32 uint32 words (bit r of plane k =
// [reg_r <= v_k]), and each kernel's count stage gets CDF_k of a pair as
// sum_w popc(A_k[w] & B_k[w]): an exact integer whatever the summation
// order. In both kernels one CTA of kThreads threads owns a kTile x kTile
// block of pairs, 4 x 4 pairs per thread, and streams the planes of its
// rows and columns through shared memory kChunk words at a time.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // CTA tile edge (pairs per side)
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 pairs each
constexpr int kChunk = 32;     // plane words per shared-memory stage

// planes[(n * nbins + k) * W + w], bit t = [regs[n, 32w + t] <= thr[k]].
__global__ void pack_planes_kernel(const uint8_t* __restrict__ regs,
                                   long long n_rows, int R,
                                   const int* __restrict__ thr, int nbins,
                                   uint32_t* __restrict__ planes) {
  const int W = R / 32;
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rows * W) return;
  long long n = gid / W;
  int w = (int)(gid % W);
  const uint4* src = reinterpret_cast<const uint4*>(regs + n * R + w * 32);
  uint4 lo = src[0], hi = src[1];
  uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  for (int k = 0; k < nbins; ++k) {
    uint32_t t = (uint32_t)thr[k];
    uint32_t bits = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        uint32_t byte = (words[q] >> (8 * b)) & 0xFFu;
        bits |= (uint32_t)(byte <= t) << (4 * q + b);
      }
    }
    planes[(n * nbins + k) * W + w] = bits;
  }
}

// Packs the nbins bit-planes of an (n_rows, R) uint8 bank (16-byte
// aligned, R a multiple of 32) into caller-allocated `planes`.
inline cudaError_t launch_pack_planes(const void* regs, long long n_rows,
                                      int R, const void* thr, int nbins,
                                      void* planes, cudaStream_t st) {
  const long long total = n_rows * (R / 32);
  const unsigned blocks = (unsigned)((total + 255) / 256);
  pack_planes_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const uint8_t*>(regs), n_rows, R,
      static_cast<const int*>(thr), nbins, static_cast<uint32_t*>(planes));
  return cudaGetLastError();
}

}  // namespace
