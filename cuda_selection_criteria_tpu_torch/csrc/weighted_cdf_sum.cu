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
// Bound on the card: the output. A pair costs nbins * R register comparisons
// (13 * 256 on the bench's aux bank at p_aux = 8: 2.2e11 a 64-tile launch at
// ti = 1024, 0.03 ms at the 7.9e15 a second that
// experiments/hopper_mma_probe.py measured for the b1 wgmma) and 4 or 8
// bytes of S and Z written once: 537 MB, 0.16 ms at 3.35 TB/s. Between the
// two sits the fold, one int-to-float conversion, one multiply and one add
// a bin and pair on the CUDA cores.
//
// Design. The pack stage (pack_planes.cuh, shared with K1) turns every bank
// row into nbins bit-planes of W = max(R/32, 8) words, one after the other:
// a row is a string of D = nbins * W/8 mma depths of 256 registers, padded
// with zero words to a whole pipeline stage of 32 words
// (ops/screen.plane_row_words). A separate column bank is packed into its
// own plane scratch. One CTA of one warpgroup (128 threads) owns a 64 x 128
// block of pairs, one m64n128 int32 accumulator tile (wgmma_b1.cuh: 64 pairs
// a thread); tj = 64 (or any odd multiple of 64) masks the columns outside
// the tile at the store. A CTA's phases (copies, counts and fold, stores)
// follow one another, so the overlap comes from kBlocks CTAs resident on an
// SM, each in a phase of its own: the registers (64 counts + 64 S a thread)
// and the ring are sized for that.
//  1. Copies. cp.async brings the block's 64 rows and 128 columns, 32 words
//     (four depths) a row and stage, into a kStages-deep ring in shared
//     memory, kAhead stages ahead, in the 128-byte-swizzle K-major layout
//     the wgmma descriptors name.
//  2. Counts. The kernel walks the string of depths: depth d belongs to bin
//     d / (W/8), so at W = 8 every wgmma of a stage is a bin of its own, at
//     W = 16 two bins share a stage, and from W = 32 on a bin is W/32 whole
//     stages. A bin's first wgmma overwrites the accumulator (scale-d = 0),
//     so nothing is zeroed; depths past the last bin are never issued.
//  3. Fold. Each bin's exact counts fold into S in registers as
//     s = s + w_k * CDF_k with _rn intrinsics (no FMA contraction: the plain
//     version rounds twice), ascending k, which makes S bit-equal to the
//     plain version. Z = CDF_0 goes from bin 0's counts straight to device
//     memory. Two accumulator tiles a thread (bin k+1's mma under bin k's
//     fold) were tried first: 2 x 64 + 64 registers spill, and ptxas then
//     serializes the wgmma (C7514) - the resident CTAs overlap instead.
//  4. Stores. In the m64n128 accumulator layout a thread holds two
//     neighbouring columns of a row and a quad of threads eight: S and Z are
//     written as float2 from registers, one full 32-byte sector a quad and
//     row. Staging a tile in shared memory for 16-byte stores of whole rows
//     was measured slower (a barrier more, and with Z a tile more of shared
//     memory, so fewer resident CTAs) and is not kept.
// experiments/k2_breakdown.py times the kernel without each of its parts.
// The Pallas kernel's `precision` (int8 / bf16 MXU operands) and `r_sub`
// (the VMEM register-axis block) have no counterpart: popcounts are exact at
// any register count.

#include "pack_planes.cuh"
#include "wgmma_b1.cuh"

namespace {

constexpr int kSumThreads = 128;  // one warpgroup
constexpr int kSumRows = 64;      // block rows: the m of m64n128
constexpr int kBlocks = 3;        // CTAs resident on an SM
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kAhead = 2;         // stages in flight ahead of the mma
constexpr int kRowSideBytes = kSumRows * kRowBytes;          // 8 KiB
constexpr int kStageBytes = kRowSideBytes + kSideBytes;      // then columns
constexpr int kRingBytes = kStages * kStageBytes;
static_assert(kBlocks * (kAtom + kRingBytes + 2048) <= 233472,
              "shared memory of the resident CTAs");
static_assert(kAhead < kStages, "a stage is refilled after its mma");

// G: mma depths of one bin inside one stage, min(W/8, 4): 1 (p <= 8), 2
// (p = 9) or 4 (p >= 10, a bin is `spb` = W/32 whole stages; spb is 1
// otherwise; its loop over a bin's stages needs more registers than
// kBlocks CTAs leave a thread, so two are resident). grid (ceil(tj/128),
// ti/64, T); block (128,); dynamic shared memory kAtom + kRingBytes.
template <int G>
__global__ void __launch_bounds__(kSumThreads, G == 4 ? 2 : kBlocks)
weighted_cdf_kernel(const uint32_t* __restrict__ planes_r,
                    const uint32_t* __restrict__ planes_c, int nbins,
                    int row_words, int spb,
                    const float* __restrict__ weights, float tail,
                    int emit_z0, const int* __restrict__ row_tiles,
                    const int* __restrict__ col_tiles, int ti, int tj,
                    float* __restrict__ s_out, float* __restrict__ z_out) {
  extern __shared__ uint8_t smem[];
  const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s =
      smem_s + ((kAtom - (smem_s & (kAtom - 1))) & (kAtom - 1));

  const int tid = threadIdx.x;
  const int t = blockIdx.z;
  const int lr0 = blockIdx.y * kSumRows;  // block offset inside the tile
  const int lc0 = blockIdx.x * kEdge;
  const long long rbase = (long long)row_tiles[t] * ti + lr0;
  const long long cbase = (long long)col_tiles[t] * tj + lc0;
  const int n_cols = min(kEdge, tj - lc0);  // columns inside the tile

  // the bin weights wait in shared memory (at most 255 bins: uint8 values)
  __shared__ float w_s[256];
  for (int k = tid; k < nbins; k += kSumThreads) w_s[k] = weights[k];

  // ---- 1. copies: this thread's cp.async pieces of a stage, 16-byte slot
  // `slot` of the rows tid / 8 + 16 i, i < 4, and of the columns
  // tid / 8 + 16 i, i < 8
  const int n_stages = row_words / kStageWords;
  const int slot = tid & 7, row0 = tid >> 3;
  const uint32_t* src_r = planes_r + (rbase + row0) * row_words + slot * 4;
  const uint32_t* src_c = planes_c + cbase * row_words + slot * 4;
  const uint32_t dst0 = swz(row0, slot);
  auto load_stage = [&](int s) {
    const uint32_t st = ring_s + (s % kStages) * kStageBytes + dst0;
    const int off = s * kStageWords;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp_async16(st + i * 16 * kRowBytes,
                 src_r + (long long)(16 * i) * row_words + off);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // columns past the tile edge read the block's first: never stored
      const int col = row0 + 16 * i;
      cp_async16(st + kRowSideBytes + i * 16 * kRowBytes,
                 src_c + (long long)(col < n_cols ? col : 0) * row_words + off);
    }
  };
  // Makes stage s readable by the mma and refills the slot of stage
  // s + kAhead - kStages, whose mma every thread has waited for.
  auto acquire = [&](int s) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (s + kAhead < n_stages) load_stage(s + kAhead);
    cp_async_commit();
  };
#pragma unroll 1
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_stages) load_stage(s);
    cp_async_commit();
  }

  // ---- 2. counts: CDF_k into acc
  int acc[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) acc[p] = 0;
  auto count = [&](int k) {
    if constexpr (G == 4) {
#pragma unroll 1
      for (int q = 0; q < spb; ++q) {
        const int s = k * spb + q;
        acquire(s);
        const uint32_t sa = ring_s + (s % kStages) * kStageBytes;
        const uint32_t sb = sa + kRowSideBytes;
        fence_acc(acc);
        wgmma_fence();
        wgmma_b1_scaled(acc, smem_desc(sa), smem_desc(sb), q);
#pragma unroll
        for (int kk = 1; kk < kSteps; ++kk)
          wgmma_b1(acc, smem_desc(sa + kk * 32), smem_desc(sb + kk * 32));
        wgmma_commit();
        wgmma_wait<0>();
      }
    } else {
      const int d = k * G;  // the bin's first depth, G of them in one stage
      const int s = d / kSteps;
      if (d % kSteps == 0) acquire(s);
      const uint32_t sa =
          ring_s + (s % kStages) * kStageBytes + (d % kSteps) * 32;
      const uint32_t sb = sa + kRowSideBytes;
      fence_acc(acc);
      wgmma_fence();
      wgmma_b1_scaled(acc, smem_desc(sa), smem_desc(sb), 0);
#pragma unroll
      for (int kk = 1; kk < G; ++kk)
        wgmma_b1(acc, smem_desc(sa + kk * 32), smem_desc(sb + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_acc(acc);
  };

  // ---- 3, 4. fold and stores. This thread's pairs 4j + 2 ri + {0, 1} are
  // the neighbouring columns 8j + 2 (tid % 4) + {0, 1} of its row ri.
  const int lc = thread_col(tid, 0);
  // value(p): this thread's pair p of the block's 64 x 128 output
  auto store = [&](float* dst, auto value) {
    float* blk = dst + ((long long)t * ti + lr0) * tj + lc0 + lc;
#pragma unroll
    for (int p = 0; p < kPairs; p += 2)
      if (lc + (p >> 2) * 8 < n_cols)
        *reinterpret_cast<float2*>(
            blk + (long long)thread_row(tid, pair_ri(p)) * tj + (p >> 2) * 8) =
            make_float2(value(p), value(p + 1));
  };
  float sv[kPairs];  // S of this thread's pairs, folded bin by bin
#pragma unroll
  for (int p = 0; p < kPairs; ++p) sv[p] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < nbins; ++k) {
    count(k);
    const float wk = w_s[k];
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
      sv[p] = __fadd_rn(sv[p], __fmul_rn(wk, (float)acc[p]));
    if (k == 0 && emit_z0)
      store(z_out, [&](int p) { return (float)acc[p]; });
  }
  store(s_out, [&](int p) { return __fadd_rn(sv[p], tail); });
}

template <int G>
cudaError_t launch_sum(const uint32_t* planes_r, const uint32_t* planes_c,
                       int nbins, int row_words, int spb,
                       const float* weights, float tail, int emit_z0,
                       const int* row_tiles, const int* col_tiles,
                       int n_tiles, int ti, int tj, float* s_out,
                       float* z_out, cudaStream_t st) {
  const int smem = kAtom + kRingBytes;
  cudaError_t err = cudaFuncSetAttribute(
      weighted_cdf_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(weighted_cdf_kernel<G>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((tj + kEdge - 1) / kEdge, ti / kSumRows, n_tiles);
  weighted_cdf_kernel<G><<<grid, kSumThreads, smem, st>>>(
      planes_r, planes_c, nbins, row_words, spb, weights, tail, emit_z0,
      row_tiles, col_tiles, ti, tj, s_out, z_out);
  return cudaGetLastError();
}

}  // namespace

// Packs the planes and launches the sum on `stream`; returns the
// cudaError_t of the launches. regs_cols == nullptr means the columns come
// from `regs` (planes_cols is then not touched). `planes` / `planes_cols`
// are caller-allocated scratch of n_rows (n_cols) * row_words uint32,
// row_words = nbins * max(R/32, 8) rounded up to a multiple of 32
// (ops/screen.plane_row_words); z_out is read only with emit_z0. Nothing is
// allocated here.
extern "C" int csc_weighted_cdf_sum(
    const void* regs, long long n_rows, const void* regs_cols,
    long long n_cols, int R, const void* thr, const void* weights,
    int nbins, float tail, int emit_z0, void* planes, void* planes_cols,
    int row_words, const void* row_tiles, const void* col_tiles, int n_tiles,
    int ti, int tj, void* s_out, void* z_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = R / 32 > kStepWords ? R / 32 : kStepWords;
  if (row_words % kStageWords != 0 || row_words < nbins * W)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_pack_planes(regs, n_rows, R, W, thr, nbins, planes,
                                       st, row_words);
  if (err != cudaSuccess) return (int)err;
  const void* pc = planes;
  if (regs_cols != nullptr) {
    err = launch_pack_planes(regs_cols, n_cols, R, W, thr, nbins,
                             planes_cols, st, row_words);
    if (err != cudaSuccess) return (int)err;
    pc = planes_cols;
  }
  const int g = W / kStepWords;  // mma depths a bin
  auto launch = g == 1 ? launch_sum<1> : g == 2 ? launch_sum<2>
                                                : launch_sum<4>;
  return (int)launch(
      static_cast<const uint32_t*>(planes), static_cast<const uint32_t*>(pc),
      nbins, row_words, g < kSteps ? 1 : g / kSteps,
      static_cast<const float*>(weights), tail, emit_z0,
      static_cast<const int*>(row_tiles), static_cast<const int*>(col_tiles),
      n_tiles, ti, tj, static_cast<float*>(s_out),
      static_cast<float*>(z_out), st);
}
