// Device helpers shared by the port's 1-bit tensor-core CDF kernels for
// NVIDIA Hopper (sm_90a): K1 (screen_fused.cu) and K2 (weighted_cdf_sum.cu).
//
// Both count CDF_k of a 128 x 128 block of pairs as the b1 product
// wgmma.mma_async m64n128k256 .and.popc of the rows' and columns' bit-planes
// (pack_planes.cuh), two warpgroups a CTA of 256 threads, each an m64n128
// int32 accumulator tile (64 pairs a thread). The operands wait in shared
// memory, K-major: a stage row is 128 bytes (32 plane words, four 256-register
// mma depths), 16-byte slot c of row r at c ^ (r mod 8), which is the
// 128-byte swizzle the wgmma descriptors name. cp.async fills the stages in
// 16-byte pieces.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEdge = 128;                // CTA block edge (pairs per side)
constexpr int kThreads = 256;             // 2 warpgroups, 64 x 128 pairs each
constexpr int kPairs = 64;                // pairs a thread: m64n128 / 128
constexpr int kStepWords = 8;             // 256 registers: one b1 mma depth
constexpr int kStageWords = 32;           // plane words a row and stage
constexpr int kSteps = kStageWords / kStepWords;       // mma depths a stage
constexpr int kRowBytes = kStageWords * 4;             // 8 slots of 16 B
constexpr int kSideBytes = kEdge * kRowBytes;          // 16 KiB
constexpr int kAtom = 1024;  // 128-byte swizzle atom: 8 rows of 128 bytes

#define CSC_WGMMA_B1_ACC                                                      \
  "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"                    \
  "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"          \
  "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"          \
  "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
#define CSC_WGMMA_B1_OUT(d)                                                   \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),     \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),            \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),        \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),        \
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),        \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),        \
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),        \
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),        \
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),        \
      "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),        \
      "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),        \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),        \
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// D (64 x 128 int32, this thread's 64) += popc(A & B) over 256 registers:
// A the warpgroup's 64 rows, B the block's 128 columns, both K-major in
// shared memory with the 128-byte swizzle (descriptors da, db). No branch
// may guard it: ptxas serializes wgmma on a path it cannot prove uniform.
__device__ __forceinline__ void wgmma_b1(int (&d)[kPairs], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc {"
      CSC_WGMMA_B1_ACC
      "}, %64, %65, 1;\n"
      : CSC_WGMMA_B1_OUT(d)
      : "l"(da), "l"(db));
}

// The same with the instruction's scale-d operand: D = popc(A & B) when
// `accumulate` is 0 (D's old contents are not read), D += popc(A & B)
// otherwise. It is an operand of the mma, not a branch around it.
__device__ __forceinline__ void wgmma_b1_scaled(int (&d)[kPairs], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc {"
      CSC_WGMMA_B1_ACC
      "}, %64, %65, p;\n"
      "}\n"
      : CSC_WGMMA_B1_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's completed shared-memory writes (cp.async) before
// the async proxy's reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses into the window in
// which a wgmma owns the registers.
__device__ __forceinline__ void fence_acc(int (&d)[kPairs]) {
#pragma unroll
  for (int i = 0; i < kPairs; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, K-major with the 128-byte swizzle: rows
// of 128 bytes, 8-row atoms kAtom bytes apart, leading offset unused.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(kAtom >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of 16-byte slot `c` of block row `row` inside one side of a
// stage: slot c of row r sits at c ^ (r mod 8), the 128-byte swizzle the
// wgmma descriptors name (the side buffers are kAtom-aligned).
__device__ __forceinline__ int swz(int row, int c) {
  return row * kRowBytes + ((c ^ (row & 7)) << 4);
}

// Pair p (0..63) of a thread is accumulator element p of its warpgroup's
// m64n128 tile: one of the thread's 2 rows, ri = (p / 2) % 2, and of its 32
// columns, ci = 2 (p / 4) + p % 2.
__device__ __forceinline__ int pair_ri(int p) { return (p >> 1) & 1; }
__device__ __forceinline__ int pair_ci(int p) {
  return (p >> 2) * 2 + (p & 1);
}
__device__ __forceinline__ int thread_row(int tid, int ri) {
  return (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2) +
         ri * 8;
}
__device__ __forceinline__ int thread_col(int tid, int ci) {
  return (ci >> 1) * 8 + (tid & 3) * 2 + (ci & 1);
}

}  // namespace
