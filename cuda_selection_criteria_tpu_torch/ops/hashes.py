"""Vectorized 64-bit integer hashing primitives, as torch ops.

Port of cuda_selection_criteria_tpu/ops/hashes.py, bit-exact with it and
with the scalar pipeline the reference applies to every canonical k-mer:

  * Thomas Wang 64-bit mix     (reference: sketch/include/sketch/hash.h:42-63)
  * canonical k-mer encoding   (reference: src/build_sketch.cpp:26-39)
  * wyhash64 stateless PRNG    (reference: sketch/include/aesctr/wy.h:41-59)

torch has no unsigned 64-bit arithmetic, so every 64-bit value lives in an
int64 tensor with the bit pattern of the reference's uint64:
  * `<<`, `+` and `*` wrap modulo 2^64, as they do on uint64;
  * `>>` on int64 is arithmetic, so every right shift of the reference is
    the logical shift _srl here;
  * unsigned order (min, compare) flips the sign bit first (umin, ult);
  * constants of 2^63 and above enter as their int64 bit patterns.
At the numpy boundary convert with ndarray.view(np.int64) / view(np.uint64)
(utils/device.as_tensor, u64_numpy).
"""

import torch

from ..utils.device import as_tensor


def _i64(v):
    """The int64 bit pattern of the unsigned 64-bit constant v."""
    return v - (1 << 64) if v >= 1 << 63 else v


# wyhash constants (reference: sketch/include/aesctr/wy.h:56-57).
WYHASH_INC = _i64(0x60BEE2BEE120FC15)
WYHASH_XOR = _i64(0xE7037ED1A0B428DB)
# WyRand maps seed 0 -> 1337 (reference: sketch/include/aesctr/wy.h:113).
WYRAND_ZERO_SEED = 1337

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
U64_MAX = -1  # 0xFFFFFFFFFFFFFFFF as int64
_LO32 = 0xFFFFFFFF


def _srl(x, s):
    """Logical right shift of int64-held uint64 values by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def ult(a, b):
    """Unsigned a < b of int64-held uint64 values."""
    return (a ^ INT64_MIN) < (b ^ INT64_MIN)


def umin(a, b):
    """Unsigned element-wise minimum of int64-held uint64 values."""
    return torch.where(ult(a, b), a, b)


def wang_hash64(x, device=None):
    """Thomas Wang's 64-bit integer mix (a bijection on [0, 2^64)).

    Matches sketch::WangHash::operator()(uint64_t) exactly
    (reference: sketch/include/sketch/hash.h:42-53)."""
    x = as_tensor(x, torch.int64, device)
    x = (~x) + (x << 21)
    x = x ^ _srl(x, 24)
    x = (x + (x << 3)) + (x << 8)  # x * 265
    x = x ^ _srl(x, 14)
    x = (x + (x << 2)) + (x << 4)  # x * 21
    x = x ^ _srl(x, 28)
    x = x + (x << 31)
    return x


def reverse_complement(kmer, k=31, device=None):
    """Reverse complement of a 2-bit packed k-mer (A=0, C=1, G=2, T=3):
    complement is bitwise NOT, base order a 2-bit-group bit reversal.
    Matches reference src/build_sketch.cpp:26-39."""
    x = as_tensor(kmer, torch.int64, device)
    x = _srl(x, 2) & 0x3333333333333333 | (x & 0x3333333333333333) << 2
    x = _srl(x, 4) & 0x0F0F0F0F0F0F0F0F | (x & 0x0F0F0F0F0F0F0F0F) << 4
    x = _srl(x, 8) & 0x00FF00FF00FF00FF | (x & 0x00FF00FF00FF00FF) << 8
    x = _srl(x, 16) & 0x0000FFFF0000FFFF | (x & 0x0000FFFF0000FFFF) << 16
    x = _srl(x, 32) | (x << 32)
    return ~x if k == 32 else _srl(~x, 64 - (k << 1))


def canonical_kmer(kmer, k=31, device=None):
    """min(kmer, reverse_complement(kmer)), unsigned: the strand-independent
    k-mer key. At k=32 both reach 2^64, where a signed min is wrong."""
    kmer = as_tensor(kmer, torch.int64, device)
    return umin(kmer, reverse_complement(kmer, k, kmer.device))


def umul128_fold(a, b, device=None):
    """(a * b) mod 2^64  XOR  (a * b) >> 64, via 32-bit limbs: wyhash's
    _wymum mixing step (reference: sketch/include/aesctr/wy.h:45-49). Every
    partial product wraps like its uint64 counterpart."""
    a = as_tensor(a, torch.int64, device)
    b = as_tensor(b, torch.int64, a.device)
    a0 = a & _LO32
    a1 = _srl(a, 32)
    b0 = b & _LO32
    b1 = _srl(b, 32)
    t = a0 * b0
    carry = _srl(t, 32)
    t1 = a1 * b0 + carry
    t2 = a0 * b1 + (t1 & _LO32)
    hi = a1 * b1 + _srl(t1, 32) + _srl(t2, 32)
    lo = a * b  # wraps mod 2^64
    return hi ^ lo


def wyrand_draws(seed, n_draws, device=None):
    """The first `n_draws` 64-bit outputs of WyRand for each seed, as an
    int64 (..., n_draws) tensor.

    WyRand's state is a pure additive counter (state += WYHASH_INC per
    draw), so draws are independent:
        draw_j = _wymum((s0 + (j+1)*INC) ^ XOR, s0 + (j+1)*INC)
    A seed of 0 maps to 1337 (reference: sketch/include/aesctr/wy.h:113).
    Each 64-bit draw serves two 32-bit gen() calls: first the LOW 32 bits,
    then the HIGH 32 bits (reference: sketch/include/aesctr/wy.h:133-142).
    """
    seed = as_tensor(seed, torch.int64, device)
    s0 = torch.where(seed == 0, WYRAND_ZERO_SEED, seed)
    j = (torch.arange(1, n_draws + 1, dtype=torch.int64, device=seed.device)
         * WYHASH_INC)
    states = s0[..., None] + j
    return umul128_fold(states ^ WYHASH_XOR, states, seed.device)


def clz64(x, device=None):
    """Count leading zeros of int64-held uint64 values (clz(0) == 64), as
    int32: exact shift halving (torch has no clz op)."""
    v = as_tensor(x, torch.int64, device)
    bits = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for sh in (32, 16, 8, 4, 2, 1):
        big = _srl(v, sh)
        take = big != 0
        bits += take.to(torch.int32) * sh
        v = torch.where(take, big, v)
    return 64 - (bits + (v != 0).to(torch.int32))
