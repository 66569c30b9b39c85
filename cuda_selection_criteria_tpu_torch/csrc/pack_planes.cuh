// The pack stage shared by the port's bit-plane CDF kernels for NVIDIA
// Hopper (sm_90a): K1 (screen_fused.cu) and K2 (weighted_cdf_sum.cu).
//
// [max(a, b) <= v] == [a <= v] & [b <= v], so the pack stage turns bank
// rows into K-1 bit-planes of R/32 uint32 words (bit r of plane k =
// [reg_r <= v_k]), and each kernel's count stage gets CDF_k of a pair from
// AND + POPC of the two rows' planes: an exact integer whatever the
// summation order. Both kernels count with the tensor cores' 1-bit wgmma
// (wgmma_b1.cuh), 8 plane words an mma depth and 32 a pipeline stage, so a
// plane is stored in Wp >= R/32 words, the words past R/32 zero (zero words
// AND to nothing). K1 pads each plane to a whole stage; K2 pads a plane to
// one depth and the whole row of planes to a whole stage (row_words).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// planes[n * row_words + k * Wp + w], bit t = [regs[g, 32w + t] <= thr[k]]
// for w < R/32, and 0 for R/32 <= w < Wp; the row's words from nbins * Wp
// to row_words are 0 too. Scratch row n holds sorted row g = n when blocks
// is null, else g = blocks[n / ti] * ti + n % ti: the slot-addressed pack of
// a K1 launch, whose scratch holds only the row blocks its tiles read. The
// sorted row g is bank row g when map is null, else bank row map[g]: the
// screened plan keeps its bank in its own row order on the card and sorts
// through the map.
__global__ void pack_planes_kernel(const uint8_t* __restrict__ regs,
                                   long long n_rows, int R, int Wp,
                                   const int* __restrict__ thr, int nbins,
                                   long long row_words,
                                   const int* __restrict__ blocks, int ti,
                                   const int* __restrict__ map,
                                   uint32_t* __restrict__ planes) {
  const int W = R / 32;
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rows * Wp) return;
  long long n = gid / Wp;
  int w = (int)(gid % Wp);
  long long g = blocks ? (long long)blocks[n / ti] * ti + n % ti : n;
  if (map) g = map[g];
  uint32_t* row = planes + n * row_words;
  for (long long x = (long long)nbins * Wp + w; x < row_words; x += Wp)
    row[x] = 0u;
  if (w >= W) {
    for (int k = 0; k < nbins; ++k) row[k * Wp + w] = 0u;
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(regs + g * R + w * 32);
  uint4 lo = src[0], hi = src[1];
  uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  for (int k = 0; k < nbins; ++k) {
    // SWAR [byte <= t] on 4 bytes at once, t = thr[k] <= 254, c = t + 1:
    // byte < c is the borrow out of bit 7 of byte - c, MAJ(~x, c7, ~d)
    // with d = (x | 0x80) - (c & 0x7f) (no borrow crosses a byte)
    const uint32_t c = (uint32_t)thr[k] + 1u;
    const uint32_t c_lo = (c & 0x7Fu) * 0x01010101u;
    const uint32_t c_hi = (c & 0x80u) ? 0x80808080u : 0u;
    uint32_t bits = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint32_t x = words[q];
      const uint32_t d = (x | 0x80808080u) - c_lo;
      const uint32_t lt = (~x & c_hi) | (~x & ~d) | (c_hi & ~d);
      // bit 7 of byte b -> bit b: bits 0, 8, 16, 24 times 0x01020408
      const uint32_t y = (lt >> 7) & 0x01010101u;
      bits |= ((y * 0x01020408u) >> 24) << (4 * q);
    }
    row[k * Wp + w] = bits;
  }
}

// Packs the nbins bit-planes of n_rows rows of a uint8 bank of R columns
// (16-byte aligned, R a multiple of 32) into caller-allocated `planes` of
// n_rows * row_words words, Wp >= R/32, row_words >= nbins * Wp (0 stands
// for nbins * Wp: the planes of a row end where the next row's begin).
// blocks null packs the first n_rows sorted rows; otherwise n_rows is a
// multiple of ti and scratch rows s * ti .. s * ti + ti - 1 get the sorted
// block blocks[s] (int32 on the card, in units of ti rows). map null: the
// bank's rows are the sorted rows; otherwise sorted row g is bank row
// map[g] (int32 on the card).
inline cudaError_t launch_pack_planes(const void* regs, long long n_rows,
                                      int R, int Wp, const void* thr,
                                      int nbins, void* planes,
                                      cudaStream_t st,
                                      long long row_words = 0,
                                      const void* blocks = nullptr,
                                      int ti = 1,
                                      const void* map = nullptr) {
  if (row_words == 0) row_words = (long long)nbins * Wp;
  const long long total = n_rows * Wp;
  const unsigned grid = (unsigned)((total + 255) / 256);
  pack_planes_kernel<<<grid, 256, 0, st>>>(
      static_cast<const uint8_t*>(regs), n_rows, R, Wp,
      static_cast<const int*>(thr), nbins, row_words,
      static_cast<const int*>(blocks), ti, static_cast<const int*>(map),
      static_cast<uint32_t*>(planes));
  return cudaGetLastError();
}

}  // namespace
