// Timing probes of the bit-plane unpack kernel (csrc/regpack_unpack.cu)
// for experiments/unpack_split.py: the kernel as the wrapper launches it,
// its byte path on the same slab, the design it replaced, both paths at
// other CTA sizes and grids, and two probes: the word path's loads and
// stores alone, and its arithmetic alone. Every other variant computes
// the kernel's rows.
//
// It includes the kernel's source, so the library also exports
// csc_regpack_unpack. The probes repeat the word path's walk (its
// pointers, word index and wrap): edit both together.

#include "../csrc/regpack_unpack.cu"

namespace us {

// ---------------------------------------------------------------------
// The design the kernel replaced, as it launched: one thread a byte of
// each of the k planes (k at run time), each byte spread to 8 bytes by a
// nibble multiply and shifted into a 64-bit index word, eight 64-bit
// extracts and table lookups, one 8-byte store, 64-bit row and byte
// counters; 256 threads a CTA, at most 16 CTAs an SM.
constexpr int kOldThreads = 256;
constexpr int kOldBlocksPerSM = 16;

__global__ void __launch_bounds__(kOldThreads)
replaced_unpack_kernel(const uint8_t* __restrict__ packed, long long groups,
                   long long r8, int k, const uint8_t* __restrict__ table,
                   uint64_t* __restrict__ out) {
  __shared__ uint8_t table_s[128];
  const int tid = threadIdx.x;
  if (tid < (1 << k)) table_s[tid] = table[tid];
  __syncthreads();

  const long long g0 = (long long)blockIdx.x * kOldThreads + tid;
  const long long stride = (long long)gridDim.x * kOldThreads;
  long long s = g0 / r8;
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

// ---------------------------------------------------------------------
// The word path's loads and stores alone: the kernel's walk, its k plane
// words loaded, the 32 output bytes made of the plane words themselves
// (no shift, mask or lookup) and stored as the kernel stores them.
template <int K>
__global__ void __launch_bounds__(kWordThreads)
us_memory_kernel(const uint32_t* __restrict__ packed, long long groups,
                 int W, uint4* __restrict__ out) {
  const long long g0 = (long long)blockIdx.x * kWordThreads + threadIdx.x;
  if (g0 >= groups) return;
  const long long stride = (long long)gridDim.x * kWordThreads;
  const long long s0 = g0 / W;
  int w = (int)(g0 - s0 * W);
  const long long ds = stride / W;
  const int dw = (int)(stride - ds * W);
  const uint32_t* src = packed + s0 * K * W + w;
  const long long src_step = ds * K * W + dw;
  const long long wrap = (long long)(K - 1) * W;
  uint4* dst = out + 2 * g0;
  const uint4* const end = out + 2 * groups;
  for (; dst < end; dst += 2 * stride) {
    uint32_t p[K];
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = __ldcs(src + (long long)j * W);
    __stcs(dst, make_uint4(p[0], p[1 % K], p[2 % K], p[3 % K]));
    __stcs(dst + 1, make_uint4(p[4 % K], p[5 % K], p[6 % K], p[7 % K]));
    src += src_step;
    w += dw;
    if (w >= W) {
      w -= W;
      src += wrap;
    }
  }
}

// The word path's arithmetic alone: the kernel's walk and decode with the
// planes taken from registers (seeded from the thread's first group and
// fed back from each decode, one XOR a plane, so no iteration can be
// hoisted), no load and no store in the loop; one 16-byte store a thread
// at the end keeps the results and the walk's last source offset.
template <int K>
__global__ void __launch_bounds__(kWordThreads)
us_arith_kernel(long long groups, int W, const uint8_t* __restrict__ table,
                uint4* __restrict__ out) {
  __shared__ uint8_t table_s[128];
  load_table<K>(table, table_s);
  const long long g0 = (long long)blockIdx.x * kWordThreads + threadIdx.x;
  if (g0 >= groups) return;
  const long long stride = (long long)gridDim.x * kWordThreads;
  const long long s0 = g0 / W;
  int w = (int)(g0 - s0 * W);
  const long long ds = stride / W;
  const int dw = (int)(stride - ds * W);
  long long src = s0 * K * W + w;  // the kernel's source offset, in words
  const long long src_step = ds * K * W + dw;
  const long long wrap = (long long)(K - 1) * W;
  uint32_t p[K];
#pragma unroll
  for (int j = 0; j < K; ++j) p[j] = (uint32_t)g0 * 0x9E3779B9u + j;
  long long g = g0;
  for (; g < groups; g += stride) {
    uint32_t v[8];
    decode_words<K>(p, table_s, v);
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] ^= v[j % 8];
    src += src_step;
    w += dw;
    if (w >= W) {
      w -= W;
      src += wrap;
    }
  }
  out[2 * g0] = make_uint4(p[0], p[K - 1], (uint32_t)src, (uint32_t)g);
}

// The CTAs an SM of `kernel` at `threads` a CTA that stay resident, in
// *cache (asked of the runtime at the first call of a process).
template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, int threads, int* cache) {
  if (*cache > 0) return cudaSuccess;
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0);
  if (err == cudaSuccess) *cache = std::max(n, 1);
  return err;
}

enum Variant {
  kKernel = 0,           // csc_regpack_unpack as the wrapper launches it
  kByte = 1,             // the byte path on the same slab, as launched
  kReplaced = 2,         // the design it replaced
  kMemory = 3,           // the word path's loads and stores alone
  kArith = 4,            // the word path's arithmetic alone (resident CTAs)
  kT128 = 5,             // the word path, 128 threads a CTA
  kT512 = 6,             // the word path, 512 threads a CTA
  kResident = 7,         // the word path's loop over the resident CTAs
  kCtas4 = 8,            // ... over 4 CTAs an SM
  kByteFlat = 9,         // the byte path, one group a thread
  kMemoryResident = 10,  // kMemory over its resident CTAs
};

template <int K>
cudaError_t run_one(int variant, const void* packed, long long s,
                    long long r8, const void* table, void* out,
                    cudaStream_t st) {
  const int W = (int)(r8 / 4);
  const long long groups = s * W;
  static int word_ctas = 0, memory_ctas = 0, arith_ctas = 0;
  unsigned blocks = 0;
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case kByte:
      return launch_bytes<K>(packed, s, r8, table, out, st);
    case kByteFlat:
      return launch_bytes<K>(packed, s, r8, table, out, st, 0);
    case kMemory:
    case kMemoryResident:
      if (variant == kMemoryResident)
        err = resident_ctas(us_memory_kernel<K>, kWordThreads, &memory_ctas);
      if (err == cudaSuccess)
        err = grid_blocks(groups, kWordThreads,
                          variant == kMemory ? 0 : memory_ctas, &blocks);
      if (err != cudaSuccess) return err;
      us_memory_kernel<K><<<blocks, kWordThreads, 0, st>>>(
          static_cast<const uint32_t*>(packed), groups, W,
          static_cast<uint4*>(out));
      return cudaGetLastError();
    case kArith:
      err = resident_ctas(us_arith_kernel<K>, kWordThreads, &arith_ctas);
      if (err == cudaSuccess)
        err = grid_blocks(groups, kWordThreads, arith_ctas, &blocks);
      if (err != cudaSuccess) return err;
      us_arith_kernel<K><<<blocks, kWordThreads, 0, st>>>(
          groups, W, static_cast<const uint8_t*>(table),
          static_cast<uint4*>(out));
      return cudaGetLastError();
    case kT128:
      return launch_words<K, 128>(packed, s, r8, table, out, st);
    case kT512:
      return launch_words<K, 512>(packed, s, r8, table, out, st);
    case kResident:
      err = resident_ctas(unpack_words_kernel<K, kWordThreads>, kWordThreads,
                          &word_ctas);
      if (err != cudaSuccess) return err;
      return launch_words<K>(packed, s, r8, table, out, st, word_ctas);
    case kCtas4:
      return launch_words<K>(packed, s, r8, table, out, st, 4);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace us

// Launches `variant` reps times, back to back on `stream`, over s rows
// of k planes of r8 bytes (the probes other than the kernel and the design
// it replaced: k = 5 or 6, R/8 a multiple of 4, out 16-byte aligned); returns
// the first cudaError_t that is not cudaSuccess.
extern "C" int unpack_split_run(int variant, int k, const void* packed,
                                long long s, long long r8, const void* table,
                                void* out, int reps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < reps; ++i) {
    cudaError_t err = cudaSuccess;
    if (variant == us::kKernel) {
      err = (cudaError_t)csc_regpack_unpack(packed, s, r8, k, table, out,
                                            stream);
    } else if (variant == us::kReplaced) {
      const long long groups = s * r8;
      unsigned blocks = 0;
      err = grid_blocks(groups, us::kOldThreads, us::kOldBlocksPerSM,
                        &blocks);
      if (err == cudaSuccess) {
        us::replaced_unpack_kernel<<<blocks, us::kOldThreads, 0, st>>>(
            static_cast<const uint8_t*>(packed), groups, r8, k,
            static_cast<const uint8_t*>(table), static_cast<uint64_t*>(out));
        err = cudaGetLastError();
      }
    } else if (k == 5 && r8 % 4 == 0) {
      err = us::run_one<5>(variant, packed, s, r8, table, out, st);
    } else if (k == 6 && r8 % 4 == 0) {
      err = us::run_one<6>(variant, packed, s, r8, table, out, st);
    } else {
      err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// CTAs an SM that the runtime would keep resident for each variant at k
// = 5 (-1 for a variant without its own kernel).
extern "C" int unpack_split_occupancy(int variant) {
  int n = -1;
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case us::kKernel:
    case us::kResident:
    case us::kCtas4:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, unpack_words_kernel<5, kWordThreads>, kWordThreads, 0);
      break;
    case us::kByte:
    case us::kByteFlat:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, unpack_bytes_kernel<5>, kByteThreads, 0);
      break;
    case us::kReplaced:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, us::replaced_unpack_kernel, us::kOldThreads, 0);
      break;
    case us::kMemory:
    case us::kMemoryResident:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, us::us_memory_kernel<5>, kWordThreads, 0);
      break;
    case us::kArith:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, us::us_arith_kernel<5>, kWordThreads, 0);
      break;
    case us::kT128:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, unpack_words_kernel<5, 128>, 128, 0);
      break;
    case us::kT512:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, unpack_words_kernel<5, 512>, 512, 0);
      break;
    default:
      break;
  }
  return err == cudaSuccess ? n : -1;
}
