// Weighted CDF sum (kernel K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_weighted_cdf_sum` of
// cuda_selection_criteria_tpu/ops/screen.py (the TPU's telescope matmuls
// behind `screen_s_z`). Plain PyTorch reference:
// cuda_selection_criteria_tpu_torch/ops/screen.py:_screen_s_z_plain.
//
// What it computes, per pair (i, j) of each scheduled (row-tile, col-tile),
// row i from `regs` and column j from `regs_cols` (the same bank unless a
// separate column bank is given):
//   CDF_k = #{r : a_ir <= v_k and b_jr <= v_k}  for the bins v_0 < ... <
//           v_{nbins-1} (exact int32)
//   S     = sum_k w_k * CDF_k  (f32, ascending k, one rounding per op)
//           + tail (added last)
//   Z     = CDF_0 (only with emit_z0, which the caller sets when v_0 == 0)
// Outputs f32 S (T, ti, tj) and, with emit_z0, f32 Z (T, ti, tj).
//
// Design: the bit-plane pack stage (pack_planes.cuh, shared with K1) and a
// POPC count stage, with a raw S/Z epilogue instead of the certificate. A
// separate column bank is packed into its own plane scratch. Counts are exact
// integers, and the weights apply once per bin in ascending order with
// _rn intrinsics (no FMA contraction), so S is bit-equal to the plain
// version. The Pallas
// kernel's `precision` (int8 / bf16 MXU operands) and `r_sub` (the VMEM
// register-axis block) have no counterpart: popcounts are exact at any
// register count, so neither is carried over. ti and tj are each a
// multiple of the 64 x 64 CTA tile.
//
// Bound on the card: integer throughput, per pair nbins * R/32
// AND + POPC + IADD (13 * 8 on the bench's aux bank at p_aux = 8), then
// 4 or 8 bytes of output per pair written once to device memory. At
// R/32 = 8 words each bin costs a shared-memory fill and two barriers for
// 8 words of work: fusing the bins into one stage is later work.

#include "pack_planes.cuh"

namespace {

constexpr int kTile = 64;      // CTA tile edge (pairs per side)
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 pairs each
constexpr int kChunk = 32;     // plane words per shared-memory stage

// The POPC count stage. CDF_k of this thread's 4 x 4 pairs: cnt[i][j] =
// sum_w popc(A & B) over the plane-k words of row row0 + ty + 16i (of
// planes_a) and column col0 + tx + 16j (of planes_b). Every thread of the
// CTA must call it.
__device__ __forceinline__ void count_bin(
    const uint32_t* __restrict__ planes_a, long long row0,
    const uint32_t* __restrict__ planes_b, long long col0, int nbins, int k,
    int W, uint32_t (*As)[kTile + 1], uint32_t (*Bs)[kTile + 1],
    int (&cnt)[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int cw = W < kChunk ? W : kChunk;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cnt[i][j] = 0;

  for (int w0 = 0; w0 < W; w0 += cw) {
    for (int idx = threadIdx.x; idx < kTile * cw; idx += kThreads) {
      const int r = idx / cw;
      const int w = idx % cw;
      As[w][r] = planes_a[((row0 + r) * nbins + k) * W + w0 + w];
      Bs[w][r] = planes_b[((col0 + r) * nbins + k) * W + w0 + w];
    }
    __syncthreads();
    for (int w = 0; w < cw; ++w) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[w][ty + 16 * i];
        b[i] = Bs[w][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cnt[i][j] += __popc(a[i] & b[j]);
    }
    __syncthreads();
  }
}

// grid (tj/64, ti/64, T); block (256,).
__global__ void __launch_bounds__(kThreads)
weighted_cdf_kernel(const uint32_t* __restrict__ planes_r,
                    const uint32_t* __restrict__ planes_c, int nbins, int W,
                    const float* __restrict__ weights, float tail,
                    int emit_z0, const int* __restrict__ row_tiles,
                    const int* __restrict__ col_tiles, int ti, int tj,
                    float* __restrict__ s_out, float* __restrict__ z_out) {
  __shared__ uint32_t As[kChunk][kTile + 1];
  __shared__ uint32_t Bs[kChunk][kTile + 1];

  const int t = blockIdx.z;
  const int lr0 = blockIdx.y * kTile;  // CTA offset inside the schedule tile
  const int lc0 = blockIdx.x * kTile;
  const long long row0 = (long long)row_tiles[t] * ti + lr0;
  const long long col0 = (long long)col_tiles[t] * tj + lc0;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float s[4][4], z[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.0f;
      z[i][j] = 0.0f;
    }

  for (int k = 0; k < nbins; ++k) {
    int cnt[4][4];
    count_bin(planes_r, row0, planes_c, col0, nbins, k, W, As, Bs, cnt);

    const float wk = weights[k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fadd_rn(s[i][j], __fmul_rn(wk, (float)cnt[i][j]));
        if (k == 0 && emit_z0) z[i][j] = (float)cnt[i][j];
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long base = ((long long)t * ti + lr0 + ty + 16 * i) * tj + lc0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lj = tx + 16 * j;
      s_out[base + lj] = __fadd_rn(s[i][j], tail);
      if (emit_z0) z_out[base + lj] = z[i][j];
    }
  }
}

}  // namespace

// Packs the planes and launches the sum on `stream`; returns the
// cudaError_t of the launches. regs_cols == nullptr means the columns come
// from `regs` (planes_cols is then not touched). `planes` / `planes_cols`
// are caller-allocated scratch of n_rows (n_cols) * nbins * (R/32) uint32;
// z_out is read only with emit_z0. Nothing is allocated here.
extern "C" int csc_weighted_cdf_sum(
    const void* regs, long long n_rows, const void* regs_cols,
    long long n_cols, int R, const void* thr, const void* weights,
    int nbins, float tail, int emit_z0, void* planes, void* planes_cols,
    const void* row_tiles, const void* col_tiles, int n_tiles, int ti,
    int tj, void* s_out, void* z_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = R / 32;
  cudaError_t err =
      launch_pack_planes(regs, n_rows, R, W, thr, nbins, planes, st);
  if (err != cudaSuccess) return (int)err;
  const void* pc = planes;
  if (regs_cols != nullptr) {
    err = launch_pack_planes(regs_cols, n_cols, R, W, thr, nbins,
                             planes_cols, st);
    if (err != cudaSuccess) return (int)err;
    pc = planes_cols;
  }
  dim3 grid(tj / kTile, ti / kTile, n_tiles);
  weighted_cdf_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(planes), static_cast<const uint32_t*>(pc),
      nbins, W, static_cast<const float*>(weights), tail, emit_z0,
      static_cast<const int*>(row_tiles), static_cast<const int*>(col_tiles),
      ti, tj, static_cast<float*>(s_out), static_cast<float*>(z_out));
  return (int)cudaGetLastError();
}
