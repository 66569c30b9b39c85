// Fused certified screen (kernel K1) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_screen_fused_call` of
// cuda_selection_criteria_tpu/ops/screen.py (the TPU's fused telescope
// matmuls + certificate compare) together with the XLA gate half
// `_fused_gates` of the same file. Plain PyTorch reference:
// cuda_selection_criteria_tpu_torch/ops/screen.py:_screen_hits_fused_plain.
//
// What it computes, per pair (i, j) of each scheduled (row-tile, col-tile):
//   CDF_k = #{r : max(a_ir, b_jr) <= v_k}  for the truncated present values
//           v_0 < ... < v_{K-1}, k < K-1 (exact int32)
//   S     = sum_k w_k * CDF_k  (f32, ascending k, one rounding per op)
//           + tail,  w_k = 2^-v_k - 2^-v_{k+1}, tail = R * 2^-v_{K-1}
//   Z     = CDF_0 when v_0 == 0
//   hit   = (3S - Z)(e'_i + e'_j) >= 2m(m - Z)   [3S(e'_i+e'_j) >= 2m^2 if
//           0 is absent], e' = e / (1 + tau_scr), AND the gates
//           i < j, j < n_real, e'_j > 0, CB e'_i >= tau_cb * e'_j, and
//           (smh) some equal LSH band fingerprint.
// Outputs int8 hits (T, ti, ti) and int32 per-tile hit counts (T,).
//
// Design. [max(a,b) <= v] == [a <= v] & [b <= v], so stage 1 packs every
// bank row into K-1 bit-planes of R/32 uint32 words (bit r of plane k =
// [reg_r <= v_k]) and stage 2 counts CDF_k = sum_w popc(A_k[w] & B_k[w]).
// Stage 1 lives in pack_planes.cuh, shared with K2 (weighted_cdf_sum.cu).
// Counts are exact integers whatever the summation order, and the weights
// apply once per bin in ascending order with explicit _rn intrinsics (no
// FMA contraction), so S - and with it the hit mask - is bit-equal to the
// plain version. One CTA owns a 64 x 64 block of one schedule tile (256
// threads, 4 x 4 pairs each), streams the planes of its 64 rows and 64
// columns through shared memory 32 words at a time, and keeps the counts
// and S/Z in registers; gates are evaluated in the epilogue from e and the
// fingerprints, so no ti^2 gate operand exists. Per-tile counts use
// integer atomicAdd (exact in any order).
//
// Bound on the card: integer throughput - per pair (K-1) * R/32
// AND + POPC + IADD (about 8 * 512 * 3 = 12k ops at p=14 with 8 bins);
// POPC issues at a quarter of the INT32 rate. Plane traffic is
// 128 rows x (K-1) x 2 KiB per CTA, mostly L2 hits. mma with .b1 operands
// (AND + POPC on the tensor cores) and wgmma belong to later work.

#include "pack_planes.cuh"

namespace {

// Stage 2: grid (ti/64, ti/64, T); block (256,).
__global__ void __launch_bounds__(kThreads)
screen_kernel(const uint32_t* __restrict__ planes, int nbins, int W,
              const float* __restrict__ weights, float tail, int want_z,
              float two_m, float two_m2,
              const int* __restrict__ row_tiles,
              const int* __restrict__ col_tiles, int ti,
              const float* __restrict__ e, float one_tau,
              const int* __restrict__ fp, int n_bands, int n_real,
              float tau_cb, int use_cb, int use_smh,
              int8_t* __restrict__ hits, int* __restrict__ counts) {
  __shared__ uint32_t As[kChunk][kTile + 1];
  __shared__ uint32_t Bs[kChunk][kTile + 1];

  const int t = blockIdx.z;
  const int lr0 = blockIdx.y * kTile;  // CTA offset inside the schedule tile
  const int lc0 = blockIdx.x * kTile;
  const long long row0 = (long long)row_tiles[t] * ti + lr0;
  const long long col0 = (long long)col_tiles[t] * ti + lc0;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int cw = W < kChunk ? W : kChunk;

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
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cnt[i][j] = 0;

    for (int w0 = 0; w0 < W; w0 += cw) {
      for (int idx = threadIdx.x; idx < kTile * cw; idx += kThreads) {
        const int r = idx / cw;
        const int w = idx % cw;
        As[w][r] = planes[((row0 + r) * nbins + k) * W + w0 + w];
        Bs[w][r] = planes[((col0 + r) * nbins + k) * W + w0 + w];
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

    const float wk = weights[k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fadd_rn(s[i][j], __fmul_rn(wk, (float)cnt[i][j]));
        if (k == 0 && want_z) z[i][j] = (float)cnt[i][j];
      }
  }

  int local = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int li = lr0 + ty + 16 * i;
    const long long gi = (long long)row_tiles[t] * ti + li;
    const float er = __fdiv_rn(e[gi], one_tau);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lj = lc0 + tx + 16 * j;
      const long long gj = (long long)col_tiles[t] * ti + lj;
      const float ec = __fdiv_rn(e[gj], one_tau);
      const float sv = __fadd_rn(s[i][j], tail);
      const float esum = __fadd_rn(er, ec);
      bool h;
      if (want_z) {
        const float zz = z[i][j];
        h = __fmul_rn(__fsub_rn(__fmul_rn(3.0f, sv), zz), esum) >=
            __fsub_rn(two_m2, __fmul_rn(two_m, zz));
      } else {
        h = __fmul_rn(__fmul_rn(3.0f, sv), esum) >= two_m2;
      }
      bool g = (gi < gj) && (gj < n_real) && (ec > 0.0f);
      if (use_cb) g = g && (er >= __fmul_rn(tau_cb, ec));
      if (use_smh && g) {
        bool band = false;
        for (int b = 0; b < n_bands; ++b)
          band |= fp[gi * n_bands + b] == fp[gj * n_bands + b];
        g = band;
      }
      const int hit = (h && g) ? 1 : 0;
      hits[((long long)t * ti + li) * ti + lj] = (int8_t)hit;
      local += hit;
    }
  }
  local = __reduce_add_sync(0xffffffffu, local);
  if ((threadIdx.x & 31) == 0 && local) atomicAdd(&counts[t], local);
}

}  // namespace

// Launches both stages on `stream`; returns the cudaError_t of the launches.
// `planes` is caller-allocated scratch of n_rows * nbins * (R/32) uint32 and
// `counts` must be zeroed by the caller. Nothing is allocated here.
extern "C" int csc_screen_fused(
    const void* regs, long long n_rows, int R, const void* thr,
    const void* weights, int nbins, float tail, int want_z, float two_m,
    float two_m2, void* planes, const void* row_tiles,
    const void* col_tiles, int n_tiles, int ti, const void* e,
    float one_tau, const void* fp, int n_bands, int n_real, float tau_cb,
    int use_cb, int use_smh, void* hits, void* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = R / 32;
  cudaError_t err = launch_pack_planes(regs, n_rows, R, thr, nbins, planes, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ti / kTile, ti / kTile, n_tiles);
  screen_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(planes), nbins, W,
      static_cast<const float*>(weights), tail, want_z, two_m, two_m2,
      static_cast<const int*>(row_tiles), static_cast<const int*>(col_tiles),
      ti, static_cast<const float*>(e), one_tau,
      static_cast<const int*>(fp), n_bands, n_real, tau_cb, use_cb, use_smh,
      static_cast<int8_t*>(hits), static_cast<int*>(counts));
  return (int)cudaGetLastError();
}
