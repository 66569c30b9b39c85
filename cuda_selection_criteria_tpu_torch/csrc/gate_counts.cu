// Gate counts (the cascade's gate prune) for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA fusions `_gate_counts` of
// cuda_selection_criteria_tpu/parallel/screened.py:232 and its strip twin
// `_ring_gate_counts` of cuda_selection_criteria_tpu/parallel/ring.py:232.
// Neither is a Pallas kernel: XLA fuses the triangle, the n_real check, CB,
// the band compares and the int32 sum into one reduction, so no mask ever
// reaches device memory. This kernel keeps it so. Plain PyTorch version:
// cuda_selection_criteria_tpu_torch/ops/screen.py:_gate_counts_plain.
//
// What it computes, for tile t of a (row tile, column tile) list over a row
// strip and a column strip: with the local ids rl = row_tiles[t]*ti + lr and
// cl = col_tiles[t]*ti + lc and the global ids gi = row_base + rl and
// gj = col_base + cl (64-bit), counts[t] is the int32 number of pairs with
//   gi < gj, gj < n_real, e_cols[cl] > 0,
//   (use_cb)  e_rows[rl] >= __fmul_rn(tau_cb, e_cols[cl]), the plain
//             version's f32 product (as K1's gates, screen_fused.cu),
//   (use_smh) fp_rows[rl*n_bands + b] == fp_cols[cl*n_bands + b] for some b.
// Exact counts, not an any-flag. Rows past the row strip's n_rows and
// columns past the column strip's n_cols count nothing: nothing is padded.
// One bank is the strip pair with both sides the same and bases 0.
//
// Bound on the card: integer compares, not bytes. A launch reads e (4 bytes
// a row) and fp (4 * n_bands bytes a row) of both strips, 18 MiB at 524,288
// rows and 8 bands, which the 50 MB L2 holds, and writes 4 bytes a tile.
// The work is ti^2 pairs a tile, each an f32 CB compare and n_bands int32
// equality tests: 1.4e11 pairs and 1.2e12 band tests over the 131,328
// tiles of a 524,288-row triangle at ti = 1024, about 0.07 s at the
// H100's int32 issue rate against the 6 ms its bytes take.
//
// Design: the loop over pairs does the compares and little else.
//  - One CTA of kRows threads per (tile, kRows-row block); each thread holds
//    its row's e and its NB fingerprints in registers (NB a template
//    argument for 1, 2, 4, 8, 16 and 32 bands; any other band count reads
//    them from memory).
//  - What depends on the column alone is done once a column, while the
//    block stages kCols columns in shared memory: e_cols > 0 and the CB
//    product fold into one f32 threshold (NaN for a dead column, so every
//    compare with it fails; -inf without CB, with the row's e read as 0),
//    and the column's fingerprints are copied beside it.
//  - The triangle, n_real and the strip's edge bound the block's column
//    range before the loop: a block wholly left of the diagonal, or past
//    n_real, returns at once. Inside the range every thread walks the same
//    columns, so the shared loads are broadcasts (16 bytes each where NB is
//    a multiple of 4), and the triangle is one 32-bit compare of the column
//    with the row's diagonal.
//  - A pair is (lc > th) & (e_r >= thr) & (some band equal), branch-free.
//  - Each thread counts in a register; a warp sum, a block sum in shared
//    memory and one integer atomicAdd a CTA give counts[t], the same in any
//    order, so the counts are deterministic.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kRows = 128;  // threads of a CTA, one row each
constexpr int kCols = 256;  // columns staged in shared memory at a time
constexpr int kWarps = kRows / 32;
constexpr int kNoBands = 0;    // use_smh off: no band gate
constexpr int kAnyBands = -1;  // n_bands known at run time only

struct GateArgs {
  const float* e_rows;
  const float* e_cols;
  const int* fp_rows;
  const int* fp_cols;
  int n_bands;
  long long n_rows, n_cols;  // rows of the row strip, of the column strip
  const int* row_tiles;
  const int* col_tiles;
  int ti;
  int row_blocks;  // CTAs a tile: ceil(ti / kRows)
  long long n_real, row_base, col_base;
  float tau_cb;
  int use_cb;
  int* counts;
};

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Some band of the row (registers) equals the column's (shared memory).
template <int NB>
__device__ __forceinline__ bool any_band(const int (&fr)[NB], const int* fc) {
  bool h = false;
  if constexpr (NB % 4 == 0) {
#pragma unroll
    for (int b = 0; b < NB; b += 4) {
      const int4 v = *reinterpret_cast<const int4*>(fc + b);
      h |= (fr[b] == v.x) | (fr[b + 1] == v.y) | (fr[b + 2] == v.z) |
           (fr[b + 3] == v.w);
    }
  } else if constexpr (NB == 2) {
    const int2 v = *reinterpret_cast<const int2*>(fc);
    h = (fr[0] == v.x) | (fr[1] == v.y);
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) h |= fr[b] == fc[b];
  }
  return h;
}

template <int NB>
__global__ void __launch_bounds__(kRows)
    gate_counts_kernel(const GateArgs a) {
  constexpr int kFr = NB > 0 ? NB : 1;  // fingerprints a row in registers
  __shared__ float thr_s[kCols];
  __shared__ __align__(16) int fp_s[kCols * kFr];
  __shared__ int part_s[kWarps];

  const int tid = threadIdx.x;
  const int t = blockIdx.x / a.row_blocks;
  const int r0 = (blockIdx.x % a.row_blocks) * kRows;  // first row in tile
  const long long rl0 = (long long)a.row_tiles[t] * a.ti + r0;
  const long long cl0 = (long long)a.col_tiles[t] * a.ti;
  const long long gc0 = a.col_base + cl0;  // the tile's first global column
  // The block's columns [lo, hi): right of its first row's diagonal, left
  // of n_real, inside the tile and the column strip. Uniform over the
  // block, so the early return leaves no thread at a barrier.
  const int lo = (int)clampll(a.row_base + rl0 - gc0 + 1, 0, a.ti);
  const int hi = (int)clampll(
      a.n_real - gc0 < a.n_cols - cl0 ? a.n_real - gc0 : a.n_cols - cl0, 0,
      a.ti);
  const int rows_here =
      (int)clampll(a.n_rows - rl0, 0, min(kRows, a.ti - r0));
  if (lo >= hi || rows_here == 0) return;

  const bool live = tid < rows_here;
  const long long rl = rl0 + tid;
  // pairs need lc > th (gi < gj); a dead row's th passes no column
  const int th = live ? (int)clampll(a.row_base + rl - gc0, -1, a.ti) : a.ti;
  const float er = live && a.use_cb ? a.e_rows[rl] : 0.0f;
  int fr[kFr];
  if constexpr (NB > 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b) fr[b] = live ? a.fp_rows[rl * NB + b] : 0;
  }

  int cnt = 0;
  for (int c0 = lo; c0 < hi; c0 += kCols) {
    const int nc = min(kCols, hi - c0);
    __syncthreads();  // the previous stage is consumed
    for (int k = tid; k < nc; k += kRows) {
      const float c = a.e_cols[cl0 + c0 + k];
      thr_s[k] = c > 0.0f ? (a.use_cb ? __fmul_rn(a.tau_cb, c) : -CUDART_INF_F)
                          : CUDART_NAN_F;
    }
    if constexpr (NB > 0) {
      const int* src = a.fp_cols + (cl0 + c0) * NB;
      for (int k = tid; k < nc * NB; k += kRows) fp_s[k] = src[k];
    }
    __syncthreads();
    for (int k = 0; k < nc; ++k) {
      bool g = (c0 + k > th) & (er >= thr_s[k]);
      if constexpr (NB > 0) {
        g &= any_band<NB>(fr, fp_s + k * NB);
      } else if constexpr (NB == kAnyBands) {
        if (g) {
          const int* fc = a.fp_cols + (cl0 + c0 + k) * a.n_bands;
          const int* fw = a.fp_rows + rl * a.n_bands;
          bool h = false;
          for (int b = 0; b < a.n_bands && !h; ++b) h = fw[b] == fc[b];
          g = h;
        }
      }
      cnt += g;
    }
  }

  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((tid & 31) == 0) part_s[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part_s[w];
    if (sum) atomicAdd(a.counts + t, sum);
  }
}

template <int NB>
cudaError_t launch(const GateArgs& a, int n_tiles, cudaStream_t st) {
  gate_counts_kernel<NB><<<n_tiles * a.row_blocks, kRows, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Per-tile gate counts of n_tiles (row tile, column tile) pairs into the
// int32 `counts`, which the caller zeroes; the tile lists are int32, e f32
// (rows,), fp int32 (rows, n_bands) row-major, all on the current device;
// n_tiles * ceil(ti / 128) must fit a grid's x. Launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError().
extern "C" int csc_gate_counts(
    const void* e_rows, const void* e_cols, const void* fp_rows,
    const void* fp_cols, int n_bands, long long n_rows, long long n_cols,
    const void* row_tiles, const void* col_tiles, int n_tiles, int ti,
    long long n_real, long long row_base, long long col_base, float tau_cb,
    int use_cb, int use_smh, void* counts, void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  const GateArgs a{static_cast<const float*>(e_rows),
                   static_cast<const float*>(e_cols),
                   static_cast<const int*>(fp_rows),
                   static_cast<const int*>(fp_cols),
                   n_bands,
                   n_rows,
                   n_cols,
                   static_cast<const int*>(row_tiles),
                   static_cast<const int*>(col_tiles),
                   ti,
                   (ti + kRows - 1) / kRows,
                   n_real,
                   row_base,
                   col_base,
                   tau_cb,
                   use_cb,
                   static_cast<int*>(counts)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (use_smh ? n_bands : kNoBands) {
    case kNoBands: return (int)launch<kNoBands>(a, n_tiles, st);
    case 1: return (int)launch<1>(a, n_tiles, st);
    case 2: return (int)launch<2>(a, n_tiles, st);
    case 4: return (int)launch<4>(a, n_tiles, st);
    case 8: return (int)launch<8>(a, n_tiles, st);
    case 16: return (int)launch<16>(a, n_tiles, st);
    case 32: return (int)launch<32>(a, n_tiles, st);
    default: return (int)launch<kAnyBands>(a, n_tiles, st);
  }
}
