// Issue-rate probe of the two tensor-core routes for the CDF counts of
// kernel K1 (cuda_selection_criteria_tpu_torch/csrc/screen_fused.cu) on
// NVIDIA Hopper (sm_90a). Built and run by experiments/hopper_mma_probe.py.
//
// kind 0: mma.sync m16n8k32 s8.s8.s32 alone (8 independent chains a warp)
// kind 1: mma.sync m16n8k256 b1.b1.s32 .and.popc alone (the same)
// kind 2: the int8 route's inner step for a 64 x 32 warp tile: ldmatrix the
//         raw uint8 registers of 64 rows and 32 columns (k = 32), make the
//         [x <= v] indicators in registers (LOP3, IADD, LOP3, PRMT a word),
//         16 mma
// kind 3: the same for a 64 x 64 warp tile (32 mma a step)
// kind 4, 5: kind 1 with 16 and 4 independent chains a warp
// kind 6: wgmma.mma_async m64n128k256 .b1 .and.popc from shared memory
//         (64 x 128 x 256 = 2097152 comparisons an instruction)
// One register comparison is one multiply-add of the int8 mma (4096 an
// instruction) or one AND + POPC bit of the b1 mma (32768 an instruction).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KIND, int CHAINS>
__global__ void __launch_bounds__(256) mma_alone(int iters, int* out) {
  int d[CHAINS][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, ~threadIdx.x, 0x5555u};
  const uint32_t b0 = threadIdx.x * 7u, b1 = 0x3333u ^ threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (KIND == 0) mma_s8(d[c], a, b0, b1);
      else mma_b1(d[c], a, b0, b1);
    }
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 0x7fffffff) out[0] = s;
}

__device__ __forceinline__ uint32_t le_mask(uint32_t x, uint32_t c7,
                                            uint32_t ch) {
  const uint32_t d = (x | 0x80808080u) - c7;
  const uint32_t lt = (~x & ch) | (~x & ~d) | (ch & ~d);  // bit 7: x <= v
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xBA98;\n" : "=r"(r) : "r"(lt));
  return r;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

constexpr int kRowB = 512 + 16;  // padded row of 512 register bytes

// MT m16 tiles x NT n8 tiles a warp; every warp reads the same tiles.
template <int MT, int NT>
__global__ void __launch_bounds__(256) int8_step(int iters, uint32_t c7,
                                                 uint32_t ch, int* out) {
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* As = sm;
  uint8_t* Bs = sm + 16 * MT * kRowB;
  for (int i = threadIdx.x; i < (16 * MT + 8 * NT) * kRowB / 4;
       i += blockDim.x)
    reinterpret_cast<uint32_t*>(sm)[i] = i * 2654435761u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int acc[MT][NT][4] = {};
  for (int it = 0; it < iters; ++it) {
    const int k0 = (it & 15) * 32;
    uint32_t a[MT][4], b[NT / 2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      ldsm_x4(a[m], As + (16 * m + (lane & 15)) * kRowB + k0 +
                        (lane >> 4) * 16);
#pragma unroll
    for (int n = 0; n < NT / 2; ++n)
      ldsm_x4(b[n], Bs + (16 * n + (lane & 7) + ((lane >> 4) << 3)) * kRowB +
                        k0 + ((lane >> 3) & 1) * 16);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[m][q] = le_mask(a[m][q], c7, ch);
#pragma unroll
    for (int n = 0; n < NT / 2; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) b[n][q] = le_mask(b[n][q], c7, ch);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_s8(acc[m][n], a[m], b[n / 2][(n & 1) * 2],
               b[n / 2][(n & 1) * 2 + 1]);
  }
  int s = 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      s += acc[m][n][0] + acc[m][n][1] + acc[m][n][2] + acc[m][n][3];
  if (s == 0x7fffffff) out[0] = s;
}


// wgmma.mma_async m64n128k256 .b1 .and.popc, A (64 rows) and B (128 rows)
// K-major in shared memory with the 128-byte swizzle, as K1 issues it.
__device__ __forceinline__ void wgmma_b1(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, 1;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Two warpgroups a block; each issues 4 dependent wgmma (one 1024-register
// stage) a commit group and keeps one group in flight.
__global__ void __launch_bounds__(256) wgmma_alone(int iters, int* out) {
  __shared__ __align__(1024) uint8_t sm[3 * 8192];
  for (int i = threadIdx.x; i < 3 * 8192 / 4; i += 256)
    reinterpret_cast<uint32_t*>(sm)[i] = i * 2654435761u;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(sm), b = a + 8192;
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_b1(d, smem_desc(a + 32 * k), smem_desc(b + 32 * k));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += d[i];
  if (s == 0x7fffffff) out[0] = s;
}

}  // namespace

// Milliseconds of one launch of `kind` (after a warm-up launch), or a
// negative cudaError_t. mma instructions issued: blocks * iters *
// (64, 64, 128, 256, 128, 32, 8)[kind] (8 warps, or 2 warpgroups for the
// wgmma of kind 6).
extern "C" float probe_ms(int kind, int blocks, int iters) {
  int* out;
  if (cudaMalloc(&out, 4) != cudaSuccess) return -1.0f;
  const int smem2 = (16 * 4 + 8 * 4) * kRowB, smem3 = (16 * 4 + 8 * 8) * kRowB;
  cudaFuncSetAttribute(int8_step<4, 4>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  cudaFuncSetAttribute(int8_step<4, 8>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  const uint32_t c7 = 12u * 0x01010101u, ch = 0u;  // v = 11
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.0f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    switch (kind) {
      case 0: mma_alone<0, 8><<<blocks, 256>>>(iters, out); break;
      case 1: mma_alone<1, 8><<<blocks, 256>>>(iters, out); break;
      case 4: mma_alone<1, 16><<<blocks, 256>>>(iters, out); break;
      case 5: mma_alone<1, 4><<<blocks, 256>>>(iters, out); break;
      case 2: int8_step<4, 4><<<blocks, 256, smem2>>>(iters, c7, ch, out);
        break;
      case 3: int8_step<4, 8><<<blocks, 256, smem3>>>(iters, c7, ch, out);
        break;
      case 6: wgmma_alone<<<blocks, 256>>>(iters, out);
    }
    cudaEventRecord(e1);
    cudaError_t err = cudaEventSynchronize(e1);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return -(float)err;
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return ms;
}
