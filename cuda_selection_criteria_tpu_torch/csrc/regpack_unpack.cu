// Decode of the packed bank upload's bit-planes (ops/regpack.unpack_rows)
// for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's unpack_place
// (cuda_selection_criteria_tpu/ops/regpack.py:122), a jitted XLA decode
// into a donated buffer; not a Pallas kernel. Plain PyTorch version:
// ops/regpack.py:_unpack_rows_plain (the same shifts, masks and table
// take).
//
// What it computes: packed holds S rows of k bit-planes of R/8 bytes each
// ((S, k, R/8) uint8, C-contiguous); bit b of byte c of plane j is bit j
// of the value index of register 8c + b. For every register r of row s:
//   out[s, r] = table[sum_j bit (r mod 8) of packed[s, j, r / 8] << j],
// with out the S contiguous rows of R bytes at the caller's row i0 and
// table the 2^k index -> value map (k in 1..7, at most 128 values).
//
// Bound on the card: bytes. The planes are read once (S k R/8) and the
// registers written once (S R): a 128 MiB slab of registers at k = 6 is
// 96 MiB read and 128 MiB written, 0.070 ms at 3.35 TB/s. The arithmetic
// has to stay under that: 2^27 registers at 1.67e13 int32 operations a
// second take 0.008 ms an operation a register. The design it replaced (one
// thread a byte of every plane: a nibble multiply a plane, 64-bit shifts
// and a 64-bit table merge, k not a compile-time constant; 26 SASS
// instructions a register as laid out, 22 of them integer) ran at 0.42 of
// the bound, held back by its integer work. experiments/unpack_split.py
// times it beside this design, with the word path's loads and stores
// alone and its arithmetic alone: on an H100 80GB HBM3 at 700 W the word
// path took 0.079-0.081 ms on the k = 5 bench slab against 0.078 for its
// loads and stores alone and 0.033 for its arithmetic alone (0.082-0.083
// ms at k = 6, arithmetic 0.038): the memory traffic binds, at 0.81-0.86
// of the byte bound.
//
// Two paths, chosen on the host by shape and alignment alone (word_path):
//
// The word path (R/8 a multiple of 4, so every p >= 5; out at row i0
// 16-byte aligned; packed 4-byte aligned). One thread decodes 32
// registers: it loads one 4-byte word of each of the k planes of a row (a
// warp reads 128 contiguous bytes a plane) and writes two 16-byte stores
// (a warp writes 1 KiB contiguous). k is a template parameter, so every
// shift and mask is a constant. For each bit b of a byte and each plane
// j, one shift and one LOP3 move bit b of each of the word's four bytes
// to bit j of a byte lane: x[b] holds the indices of registers b, 8 + b,
// 16 + b and 24 + b, about half an instruction a register a plane. Each
// index byte is taken out (a mask, a shift or a __byte_perm) and looked
// up in the table in shared memory (128 bytes, one word a bank: a lookup
// never conflicts), and three __byte_perm a word regroup the values into
// registers 32c .. 32c + 31 in order (the lookup before the byte
// transpose: after it, every value would still need its own lookup).
// 196 SASS instructions a 32-register pass at k = 5 (6.1 a register, 4.9
// integer) and 209 at k = 6 (6.5, 5.3). Group g of the launch (row g / W,
// word g mod W, W = R/32) writes 32-byte block g of out, since R = 32 W.
// The launch gives every group its own thread: a grid-stride loop over
// the resident CTAs ran 11-23% slower on the slabs above (why is not
// measured; likeliest, its warps drift apart through the slab), so the
// loop, which advances the row and word by the stride's own quotient and
// remainder as pointers and a 32-bit word index (no division in the
// loop), runs once a thread unless a caller caps the grid.
//
// The byte path (every other shape: a ragged R/8, or out aligned to 8
// bytes but not 16). The replaced design's loop, templated on k: one thread
// a byte of each plane (8 registers), each byte spread to 8 bytes by a
// nibble multiply ((n * 0x00204081) & 0x01010101: the shifted copies do not
// overlap, so no carries), the table in shared memory, one 8-byte store;
// byte loads are never misaligned, whatever R/8 is. 16-17 SASS
// instructions a register; 0.109-0.116 ms on the slabs above, with its
// grid-stride loop at 16 CTAs an SM (one group a thread: 0.147-0.155).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kWordThreads = 256;
constexpr int kByteThreads = 256;
constexpr int kByteBlocksPerSM = 16;

// The word path takes rows of R/8 = 4 W bytes a plane, W < 2^31, an out
// 16-byte aligned and planes 4-byte aligned; any other shape takes the
// byte path.
bool word_path(long long r8, const void* packed, const void* out) {
  return r8 % 4 == 0 && r8 / 4 <= INT_MAX &&
         reinterpret_cast<uintptr_t>(packed) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <int K>
__device__ __forceinline__ void load_table(const uint8_t* __restrict__ table,
                                           uint8_t* table_s) {
  if (threadIdx.x < (1 << K)) table_s[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
}

// byte c of x, zero-extended: the table index of one register
template <int C>
__device__ __forceinline__ uint32_t index_byte(uint32_t x) {
  if (C == 0) return x & 0xFFu;
  if (C == 3) return x >> 24;
  return __byte_perm(x, 0u, 0x4440u | C);
}

// The 32 registers of one word of each of the K planes, as 8 words in
// register order.
template <int K>
__device__ __forceinline__ void decode_words(const uint32_t (&p)[K],
                                             const uint8_t* table_s,
                                             uint32_t (&w)[8]) {
  // x[b], byte c: the index of register 8c + b (bit j from plane j)
  uint32_t x[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    uint32_t acc = 0u;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t t = b >= j ? p[j] >> (b - j) : p[j] << (j - b);
      acc |= t & (0x01010101u << j);
    }
    x[b] = acc;
  }
  // word 2c + h holds registers 8c + 4h .. 8c + 4h + 3
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t v[4][4];  // v[t][c]: the value of register 8c + 4h + t
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t xi = x[4 * h + t];
      v[t][0] = table_s[index_byte<0>(xi)];
      v[t][1] = table_s[index_byte<1>(xi)];
      v[t][2] = table_s[index_byte<2>(xi)];
      v[t][3] = table_s[index_byte<3>(xi)];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t lo = __byte_perm(v[0][c], v[1][c], 0x0040u);
      const uint32_t hi = __byte_perm(v[2][c], v[3][c], 0x0040u);
      w[2 * c + h] = __byte_perm(lo, hi, 0x5410u);
    }
  }
}

// grid (blocks,), block (Threads,). packed: the planes as words, W words
// a plane; out: S * W blocks of 32 bytes (two uint4), the destination
// rows; groups = S * W.
template <int K, int Threads>
__global__ void __launch_bounds__(Threads)
unpack_words_kernel(const uint32_t* __restrict__ packed, long long groups,
                    int W, const uint8_t* __restrict__ table,
                    uint4* __restrict__ out) {
  __shared__ uint8_t table_s[128];
  load_table<K>(table, table_s);

  const long long g0 = (long long)blockIdx.x * Threads + threadIdx.x;
  if (g0 >= groups) return;
  const long long stride = (long long)gridDim.x * Threads;
  const long long s0 = g0 / W;  // the group's row and word
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
    uint32_t v[8];
    decode_words<K>(p, table_s, v);
    __stcs(dst, make_uint4(v[0], v[1], v[2], v[3]));
    __stcs(dst + 1, make_uint4(v[4], v[5], v[6], v[7]));
    src += src_step;
    w += dw;
    if (w >= W) {
      w -= W;
      src += wrap;
    }
  }
}

// bit i of the low nibble -> bit 0 of byte i, for i < 4
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// bit i of the byte -> bit 0 of byte i of the word
__device__ __forceinline__ uint64_t spread8(uint32_t b) {
  return (uint64_t)spread4(b & 0xFu) |
         ((uint64_t)spread4((b >> 4) & 0xFu) << 32);
}

// grid (blocks,), block (kByteThreads,). out: S * r8 8-byte words, the
// destination rows; groups = S * r8.
template <int K>
__global__ void __launch_bounds__(kByteThreads)
unpack_bytes_kernel(const uint8_t* __restrict__ packed, long long groups,
                    long long r8, const uint8_t* __restrict__ table,
                    uint64_t* __restrict__ out) {
  __shared__ uint8_t table_s[128];
  load_table<K>(table, table_s);

  const long long g0 = (long long)blockIdx.x * kByteThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kByteThreads;
  long long s = g0 / r8;  // the group's row and byte
  long long c = g0 - s * r8;
  const long long ds = stride / r8;
  const long long dc = stride - ds * r8;
  for (long long g = g0; g < groups; g += stride) {
    const uint8_t* src = packed + s * K * r8 + c;
    uint64_t idx = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) idx |= spread8(__ldcs(src + j * r8)) << j;
    uint64_t v = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      v |= (uint64_t)table_s[(idx >> (8 * b)) & 0x7Fu] << (8 * b);
    out[g] = v;
    s += ds;
    c += dc;
    if (c >= r8) {
      c -= r8;
      ++s;
    }
  }
}

// CTAs for `groups` groups of `threads` threads: one group a thread, or
// where per_sm > 0 at most per_sm CTAs an SM (a grid-stride loop then
// walks the rest).
cudaError_t grid_blocks(long long groups, int threads, int per_sm,
                        unsigned* blocks) {
  long long most = INT_MAX;
  if (per_sm > 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    most = (long long)sms * per_sm;
  }
  *blocks = (unsigned)std::min((groups + threads - 1) / threads, most);
  return cudaSuccess;
}

// The word path launches one group a thread (the head says why); per_sm
// > 0 caps the CTAs an SM (the split's probes).
template <int K, int Threads = kWordThreads>
cudaError_t launch_words(const void* packed, long long s, long long r8,
                         const void* table, void* out, cudaStream_t stream,
                         int per_sm = 0) {
  const int W = (int)(r8 / 4);
  const long long groups = s * W;
  unsigned blocks = 0;
  cudaError_t err = grid_blocks(groups, Threads, per_sm, &blocks);
  if (err != cudaSuccess) return err;
  unpack_words_kernel<K, Threads><<<blocks, Threads, 0, stream>>>(
      static_cast<const uint32_t*>(packed), groups, W,
      static_cast<const uint8_t*>(table), static_cast<uint4*>(out));
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_bytes(const void* packed, long long s, long long r8,
                         const void* table, void* out, cudaStream_t stream,
                         int per_sm = kByteBlocksPerSM) {
  const long long groups = s * r8;
  unsigned blocks = 0;
  cudaError_t err = grid_blocks(groups, kByteThreads, per_sm, &blocks);
  if (err != cudaSuccess) return err;
  unpack_bytes_kernel<K><<<blocks, kByteThreads, 0, stream>>>(
      static_cast<const uint8_t*>(packed), groups, r8,
      static_cast<const uint8_t*>(table), static_cast<uint64_t*>(out));
  return cudaGetLastError();
}

template <int K>
cudaError_t launch(const void* packed, long long s, long long r8,
                   const void* table, void* out, cudaStream_t stream) {
  return word_path(r8, packed, out)
             ? launch_words<K>(packed, s, r8, table, out, stream)
             : launch_bytes<K>(packed, s, r8, table, out, stream);
}

}  // namespace

// 1 where csc_regpack_unpack takes the word path for these planes and
// this destination, else 0 (the byte path).
extern "C" int csc_regpack_unpack_word_path(long long r8, const void* packed,
                                            const void* out) {
  return word_path(r8, packed, out) ? 1 : 0;
}

// Launches the decode of s rows of k planes of r8 bytes at `packed` into
// the s * 8 * r8 bytes at `out` (8-byte aligned: the caller's row i0 of a
// contiguous bank) through the 2^k-byte `table`, on `stream`; returns the
// cudaError_t of the launch. Nothing is allocated here.
extern "C" int csc_regpack_unpack(const void* packed, long long s,
                                  long long r8, int k, const void* table,
                                  void* out, void* stream) {
  if (k < 1 || k > 7 || s < 0 || r8 < 0)
    return (int)cudaErrorInvalidValue;
  if (s == 0 || r8 == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)launch<1>(packed, s, r8, table, out, st);
    case 2: return (int)launch<2>(packed, s, r8, table, out, st);
    case 3: return (int)launch<3>(packed, s, r8, table, out, st);
    case 4: return (int)launch<4>(packed, s, r8, table, out, st);
    case 5: return (int)launch<5>(packed, s, r8, table, out, st);
    case 6: return (int)launch<6>(packed, s, r8, table, out, st);
    default: return (int)launch<7>(packed, s, r8, table, out, st);
  }
}
