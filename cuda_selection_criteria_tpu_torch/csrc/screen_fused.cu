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
// Rows and columns may come from two banks (the ring engine's strip
// variant, `screen_hits_fused_strips` of the same file): row tiles index the
// row bank, its e and fp, column tiles the column bank, its e and fp, each in
// local ids; the triangle and tail gates compare the global ids row_base +
// local row and col_base + local column. One bank with bases 0 is the
// single-bank screen. A side's tiles count sorted rows; with a row map
// (int32, one entry a sorted row) the pack reads sorted row g from bank row
// map[g], so the screened plan's bank stays in its own row order on the card
// (the map sends padded positions to a zero row).
//
// Bound on the card. The counts are (K-1) * R register comparisons a pair
// that passes the gates: 7.4e12 for the first 64 tiles of the bench
// triangle at ti = 1024, p = 14, 7 bins, where 96% of the pairs pass. As
// int8 indicator products (the TPU's route) that is 1.5e13 ops, 7.5 ms at
// the H100's 1,979 TOP/s. The probe experiments/hopper_mma_probe.py
// measured, on an H100 80GB HBM3 at 700 W, mma.sync m16n8k256 .b1 .and.popc
// at the issue rate of m16n8k32 .s8 (1.6e11 a second): a b1 mma compares
// 32768 registers where an int8 one compares 4096, so b1 is 8x the int8
// route, which would also spend ALU work making its indicators. The b1
// wgmma.mma_async m64n128k256 from shared memory reaches 7.9e15
// comparisons a second, 1.5x the b1 mma.sync. The counts therefore run on
// b1 wgmma, and at that rate the bound is 0.94 ms (the bank read once and
// the hits written once take 0.1 ms; chip_smoke.py computes both).
//
// Design. [max(a,b) <= v] == [a <= v] & [b <= v], so the pack stage
// (pack_planes.cuh, shared with K2) turns bank rows into K-1 bit-planes of
// Wp words, Wp = max(R/32, 32) (ops/screen.plane_words: zero words pad a
// plane to one pipeline stage), and CDF_k is the b1 wgmma (AND + POPC) of
// the row's and column's plane k. The pack covers only the launch's row
// blocks: the caller lists each side's distinct blocks (the TPU kernel's
// BlockSpec index maps read only the tiles' rows too), the pack writes
// block list[s] into scratch slot s, and each tile carries the slots of its
// row and column blocks (ops/screen.LaunchTiles). The slots address the
// planes and nothing else; the gates, e, fp and the hits keep the tile
// ids. One CTA of two warpgroups owns a 128 x 128 block of pairs, each
// warpgroup an m64n128 accumulator tile (64 pairs a thread); ti = 64 (or
// any odd multiple of 64) masks the part of the block outside the tile.
//  1. Gates first. e' of the block's rows and columns is divided once into
//     shared memory; each thread evaluates the gates of its 64 pairs
//     exactly as the plain version does (the same f32 _rn operations) into
//     a 64-bit mask. If no pair of the block passes (__syncthreads_or), the
//     whole CTA writes zero hits and returns: hit = h AND g, so nothing else
//     is needed. A live block counts in full: ptxas serializes wgmma on any
//     path it cannot prove uniform, so no finer skip guards the mma.
//  2. Counts. Bins run in groups of kGroup, each group one pass over the
//     register axis: cp.async copies the group's planes of the block's 128
//     rows and 128 columns, 32 words (1024 registers) a row and stage, into
//     a kStages-deep ring in shared memory, kAhead stages ahead, laid out
//     K-major with the 128-byte swizzle that the wgmma descriptors name.
//     Each warpgroup issues 4 wgmma a stage into one int32 accumulator tile
//     per bin and keeps one stage's group in flight. Counts are exact
//     integers whatever the order.
//  3. After a group, each bin's counts fold into S in registers, ascending
//     k, as s = s + w_k * CDF_k with _rn intrinsics (no FMA contraction);
//     Z = CDF_0 waits in shared memory.
//  4. Epilogue: the certificate and the gates as before; the int8 hits are
//     staged in shared memory and written as 16-byte stores, and per-tile
//     counts use one integer atomicAdd a warp.

#include "pack_planes.cuh"
#include "wgmma_b1.cuh"  // the block shape, the b1 wgmma, cp.async, swizzle

namespace {

// Bins a pass over the register axis. Each bin has planes of its own, so
// a group shares no loads on this route; a larger group only costs shared
// memory (its stages) and registers (its accumulators).
constexpr int kGroup = 1;
constexpr int kStages = 4;                // cp.async ring depth
constexpr int kAhead = 2;                 // stages in flight ahead of the mma
constexpr int kStageBytes = kGroup * 2 * kSideBytes;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kSlotBytes = kPairs * kThreads * 4;      // Z: 64 KiB
constexpr int kHitStride = kEdge + 16;    // staged hit row (bytes)
static_assert(kEdge * kHitStride <= kRingBytes, "hit staging fits the ring");
static_assert(kAtom + kRingBytes + kSlotBytes <= 232448, "shared memory");
static_assert(kAhead < kStages - 1, "a stage is refilled after its mma");

// grid (ceil(ti/128), ceil(ti/128), T); block (256,); dynamic shared
// memory kAtom + kRingBytes (+ kSlotBytes with want_z).
__global__ void __launch_bounds__(kThreads, 1)
screen_kernel(const uint32_t* __restrict__ planes_r,
              const uint32_t* __restrict__ planes_c, int nbins, int Wp,
              const float* __restrict__ weights, float tail, int want_z,
              float two_m, float two_m2,
              const int* __restrict__ row_tiles,
              const int* __restrict__ col_tiles,
              const int* __restrict__ row_slot,
              const int* __restrict__ col_slot, int ti,
              const float* __restrict__ e_r, const float* __restrict__ e_c,
              float one_tau, const int* __restrict__ fp_r,
              const int* __restrict__ fp_c, int n_bands, long long n_real,
              long long row_base, long long col_base, float tau_cb,
              int use_cb, int use_smh, int8_t* __restrict__ hits,
              int* __restrict__ counts) {
  extern __shared__ uint8_t smem[];
  // e' = e / (1 + tau_scr) of the block's rows, then its columns (0 past
  // the tile edge), IEEE-rounded as the plain version's tensor division
  __shared__ float e_s[2 * kEdge];
  const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t pad = (kAtom - (smem_s & (kAtom - 1))) & (kAtom - 1);
  uint8_t* ring = smem + pad;
  const uint32_t ring_s = smem_s + pad;
  float* z_slot = reinterpret_cast<float*>(ring + kRingBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int t = blockIdx.z;
  const int lr0 = blockIdx.y * kEdge;  // block offset inside the tile
  const int lc0 = blockIdx.x * kEdge;
  // local ids: they index e and fp of their own side's bank
  const long long rbase = (long long)row_tiles[t] * ti + lr0;
  const long long cbase = (long long)col_tiles[t] * ti + lc0;
  const int n_rows = min(kEdge, ti - lr0);  // rows and columns of the block
  const int n_cols = min(kEdge, ti - lc0);  // that lie inside the tile

  // ---- 1. gates (the plain version's comparisons, operation for operation)
  {
    const int l = tid & (kEdge - 1);
    const bool col = tid >= kEdge;
    e_s[tid] = l < (col ? n_cols : n_rows)
                   ? __fdiv_rn(col ? e_c[cbase + l] : e_r[rbase + l], one_tau)
                   : 0.0f;
  }
  __syncthreads();
  uint64_t gm = 0;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int lr = thread_row(tid, pair_ri(p));
    const int lc = thread_col(tid, pair_ci(p));
    // global ids: the triangle and the tail of real rows
    const long long gi = row_base + rbase + lr, gj = col_base + cbase + lc;
    const float r = e_s[lr], c = e_s[kEdge + lc];
    bool g = lr < n_rows && lc < n_cols && gi < gj && gj < n_real && c > 0.0f;
    if (use_cb) g = g && r >= __fmul_rn(tau_cb, c);
    if (g) gm |= 1ull << p;
  }
  if (use_smh && gm) {
    uint64_t band = 0;
    for (int b = 0; b < n_bands; ++b) {
      int fr[2], fc[32];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int lr = thread_row(tid, k);
        fr[k] = lr < n_rows ? fp_r[(rbase + lr) * n_bands + b] : 0;
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int lc = thread_col(tid, k);
        fc[k] = lc < n_cols ? fp_c[(cbase + lc) * n_bands + b] : 0;
      }
#pragma unroll
      for (int p = 0; p < kPairs; ++p)
        if (fr[pair_ri(p)] == fc[pair_ci(p)]) band |= 1ull << p;
    }
    gm &= band;
  }

  if (!__syncthreads_or(gm != 0)) {
    // no pair of the block passes its gates: zero hits, nothing to count
    const int chunks = n_cols / 16;
    for (int c = tid; c < n_rows * chunks; c += kThreads) {
      const int r = c / chunks;
      *reinterpret_cast<uint4*>(
          hits + ((long long)t * ti + lr0 + r) * ti + lc0 + (c % chunks) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  // ---- 2. counts: bins in groups of kGroup, kStageWords words a stage
  // the block's first row and column in the plane scratch, read past the
  // skip; in 32 bits (scratch rows never exceed the bank's): with 64-bit
  // offsets here the kernel ran 4% slower than with tile ids
  // (experiments/k1_breakdown.py, variant tile_addressed)
  const int rplane = row_slot[t] * ti + lr0;
  const int cplane = col_slot[t] * ti + lc0;
  const int stages_per_group = Wp / kStageWords;
  const int n_steps = ((nbins + kGroup - 1) / kGroup) * stages_per_group;

  // This thread's cp.async pieces, for each bin of a group: 16-byte slot
  // `slot` of (side, row) = (i / 4, tid / 8 + 32 (i % 4)), i < 8.
  const int slot = tid & 7;
  const uint32_t* src[8];
  uint32_t dst[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int side = i >> 2, row = (tid >> 3) + 32 * (i & 3);
    // rows past the tile edge read the block's first row: dead pairs
    const int l = row < (side ? n_cols : n_rows) ? row : 0;
    src[i] = (side ? planes_c + (long long)(cplane + l) * nbins * Wp
                   : planes_r + (long long)(rplane + l) * nbins * Wp) +
             slot * 4;
    dst[i] = side * kSideBytes + swz(row, slot);
  }
  auto load_stage = [&](int s) {
    const int grp = s / stages_per_group;
    const uint32_t st = ring_s + (s % kStages) * kStageBytes;
    const long long off = (long long)grp * kGroup * Wp +
                          (s % stages_per_group) * kStageWords;
#pragma unroll
    for (int b = 0; b < kGroup; ++b)
      if (grp * kGroup + b < nbins)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          cp_async16(st + b * 2 * kSideBytes + dst[i], src[i] + off + b * Wp);
  };

#pragma unroll 1
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_steps) load_stage(s);
    cp_async_commit();
  }
  float sv[kPairs];  // S of this thread's pairs, folded bin by bin
#pragma unroll
  for (int p = 0; p < kPairs; ++p) sv[p] = 0.0f;
  int s = 0;         // the ring's stage counter, across groups
#pragma unroll 1
  for (int grp = 0; grp * kGroup < nbins; ++grp) {
    int acc[kGroup][kPairs];
#pragma unroll
    for (int b = 0; b < kGroup; ++b)
#pragma unroll
      for (int p = 0; p < kPairs; ++p) acc[b][p] = 0;

#pragma unroll 1
    for (int k = 0; k < stages_per_group; ++k, ++s) {
      cp_async_wait<kAhead - 1>();
      fence_proxy_async();
      // After the barrier stage s is in shared memory for every thread, and
      // every warpgroup has waited for the mma of stage s + kAhead - kStages
      // (its last wait left only stage s - 1 in flight), whose slot is
      // refilled here.
      __syncthreads();
      if (s + kAhead < n_steps) load_stage(s + kAhead);
      cp_async_commit();
      const uint32_t st = ring_s + (s % kStages) * kStageBytes;
#pragma unroll
      for (int b = 0; b < kGroup; ++b) {
        const uint32_t sa = st + (b * 2) * kSideBytes + wg * 64 * kRowBytes;
        const uint32_t sb = st + (b * 2 + 1) * kSideBytes;
        fence_acc(acc[b]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          wgmma_b1(acc[b], smem_desc(sa + kk * 32), smem_desc(sb + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the mma of stage s - 1 has read its slot
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kGroup; ++b) fence_acc(acc[b]);

    // ---- 3. fold the group's counts into S (and Z), ascending bins
#pragma unroll
    for (int b = 0; b < kGroup; ++b) {
      const int bin = grp * kGroup + b;
      if (bin >= nbins) continue;
      const float wk = weights[bin];
#pragma unroll
      for (int p = 0; p < kPairs; ++p)
        sv[p] = __fadd_rn(sv[p], __fmul_rn(wk, (float)acc[b][p]));
      if (bin == 0 && want_z)
#pragma unroll
        for (int p = 0; p < kPairs; ++p)
          z_slot[p * kThreads + tid] = (float)acc[b][p];
    }
  }

  // ---- 4. epilogue: certificate AND gates, staged int8 hits, counts
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it stages the hits
  int8_t* hit_tile = reinterpret_cast<int8_t*>(ring);
  uint64_t hm = 0;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int lr = thread_row(tid, pair_ri(p));
    const int lc = thread_col(tid, pair_ci(p));
    if ((gm >> p) & 1) {
      const float st = __fadd_rn(sv[p], tail);
      const float esum = __fadd_rn(e_s[lr], e_s[kEdge + lc]);
      bool h;
      if (want_z) {
        const float zz = z_slot[p * kThreads + tid];
        h = __fmul_rn(__fsub_rn(__fmul_rn(3.0f, st), zz), esum) >=
            __fsub_rn(two_m2, __fmul_rn(two_m, zz));
      } else {
        h = __fmul_rn(__fmul_rn(3.0f, st), esum) >= two_m2;
      }
      if (h) hm |= 1ull << p;
    }
    hit_tile[lr * kHitStride + lc] = (int8_t)((hm >> p) & 1);
  }
  __syncthreads();
  const int chunks = n_cols / 16;
  for (int c = tid; c < n_rows * chunks; c += kThreads) {
    const int r = c / chunks, c16 = (c % chunks) * 16;
    *reinterpret_cast<uint4*>(hits + ((long long)t * ti + lr0 + r) * ti +
                              lc0 + c16) =
        *reinterpret_cast<const uint4*>(hit_tile + r * kHitStride + c16);
  }
  int local = __popcll(hm);
  local = __reduce_add_sync(0xffffffffu, local);
  if (lane == 0 && local) atomicAdd(&counts[t], local);
}

}  // namespace

// Launches the pack stage and the screen on `stream`; returns the
// cudaError_t of the launches. row_map / col_map (int32, one entry a sorted
// row, or null for a bank whose rows are the sorted rows) give the bank row
// of each sorted row of regs / regs_cols. row_blocks (n_row_blocks int32)
// lists the distinct sorted row blocks of regs that the tiles read,
// col_blocks (n_col_blocks) those of regs_cols; row_slot / col_slot
// (n_tiles int32) give each tile's place in them. `planes` / `planes_cols` are
// caller-allocated scratch of n_row_blocks / n_col_blocks * ti * nbins * Wp
// uint32, Wp = max(R/32, 32) (ops/screen.plane_words); with planes_cols ==
// planes (the caller's sign that regs_cols is regs and one block list
// serves both sides) the column side reads `planes` and the blocks are
// packed once; distinct scratch always gets regs_cols' blocks packed into
// it. `counts` must be zeroed by the caller. Nothing is allocated here.
extern "C" int csc_screen_fused(
    const void* regs, const void* regs_cols, const void* row_map,
    const void* col_map, int R, const void* thr,
    const void* weights, int nbins, float tail, int want_z, float two_m,
    float two_m2, void* planes, void* planes_cols, int Wp,
    const void* row_blocks, int n_row_blocks, const void* col_blocks,
    int n_col_blocks, const void* row_tiles, const void* col_tiles,
    const void* row_slot, const void* col_slot, int n_tiles, int ti,
    const void* e, const void* e_cols, float one_tau,
    const void* fp, const void* fp_cols, int n_bands, long long n_real,
    long long row_base, long long col_base, float tau_cb, int use_cb,
    int use_smh, void* hits, void* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      launch_pack_planes(regs, (long long)n_row_blocks * ti, R, Wp, thr,
                         nbins, planes, st, 0, row_blocks, ti, row_map);
  if (err != cudaSuccess) return (int)err;
  if (planes_cols != planes) {
    err = launch_pack_planes(regs_cols, (long long)n_col_blocks * ti, R, Wp,
                             thr, nbins, planes_cols, st, 0, col_blocks, ti,
                             col_map);
    if (err != cudaSuccess) return (int)err;
  }
  const int smem = kAtom + kRingBytes + (want_z ? kSlotBytes : 0);
  err = cudaFuncSetAttribute(screen_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kAtom + kRingBytes + kSlotBytes);
  if (err != cudaSuccess) return (int)err;
  const int nb = (ti + kEdge - 1) / kEdge;
  dim3 grid(nb, nb, n_tiles);
  screen_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint32_t*>(planes),
      static_cast<const uint32_t*>(planes_cols),
      nbins, Wp, static_cast<const float*>(weights), tail, want_z, two_m,
      two_m2, static_cast<const int*>(row_tiles),
      static_cast<const int*>(col_tiles), static_cast<const int*>(row_slot),
      static_cast<const int*>(col_slot), ti, static_cast<const float*>(e),
      static_cast<const float*>(e_cols), one_tau,
      static_cast<const int*>(fp), static_cast<const int*>(fp_cols), n_bands,
      n_real, row_base, col_base, tau_cb, use_cb, use_smh,
      static_cast<int8_t*>(hits), static_cast<int*>(counts));
  return (int)cudaGetLastError();
}
