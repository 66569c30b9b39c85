"""Bit-plane register packing for the host-to-device bank upload.

Port of cuda_selection_criteria_tpu/ops/regpack.py. The HLL register
alphabet of a real bank is small - a zero bin plus a band around
log2(n/m) - so an 8-bit register carries 4-6 bits of value index. The
packed upload (parallel/screened.upload_sorted_rows(pack=)) ships k
bit-planes of the index (k = ceil(log2(len(values)))) instead of the raw
bytes: k/8 of the bytes over the host link, decoded on the device.

  pack:   host, numpy or the native packers (native/fastx.cpp) -
          idx = lut256[regs]; plane j = the bits j of 8 indices a byte,
          little bit order: (S, k, R/8) uint8.
  unpack: device - unpack_rows: out[i0 + s, r] = table[sum_j bit (r mod 8)
          of packed[s, j, r // 8] << j], the hand-written kernel
          csrc/regpack_unpack.cu on a CUDA tensor, _unpack_rows_plain (the
          JAX unpack_place's shifts, masks and table take) on a CPU one.

The native routes run whenever fastx.available(); without the library the
numpy forms give the same bytes. The roundtrip is bit-exact for any
alphabet the plan was made from.
"""

import ctypes

import numpy as np
import torch

from ..native import fastx
from . import _build
from .screen import _bank_values_plain, _check, _launch


def host_values(regs, chunk=1 << 24):
    """Sorted tuple of the distinct byte values of a uint8 host bank: the
    alphabet of a packed upload, read before the bank goes to the device
    (the JAX package's host bank_values). One native pass
    (fastx.value_presence) when the library is built and the bank
    contiguous; otherwise the presence kernel's plain version
    (screen._bank_values_plain, a bincount `chunk` bytes at a time)."""
    a = np.asarray(regs)
    if fastx.available() and a.flags.c_contiguous:
        return tuple(int(v) for v in np.nonzero(fastx.value_presence(a))[0])
    return _bank_values_plain(torch.from_numpy(np.ascontiguousarray(a))
                              .reshape(-1), chunk)


def plan_pack(values):
    """(lut256, table, k) for a present-value alphabet, or None when
    packing cannot save bytes (a value above 255, or k >= 8).

    lut256: uint8 value -> index map (absent values map to 0; callers
    only feed values from the alphabet). table: uint8 (2^k,) index ->
    value, zero-padded."""
    vals = sorted(int(v) for v in values)
    if not vals or vals[-1] > 255:
        return None
    k = max(1, int(np.ceil(np.log2(max(len(vals), 2)))))
    if k >= 8:
        return None
    lut256 = np.zeros(256, np.uint8)
    for i, v in enumerate(vals):
        lut256[v] = i
    table = np.zeros(1 << k, np.uint8)
    table[: len(vals)] = vals
    return lut256, table, k


def pack_rows(rows, lut256, k, out=None, scratch=None, threads=None):
    """(S, R) uint8 registers -> (S, k, R//8) uint8 bit-planes (R a
    multiple of 8; every HLL m = 2^p >= 8 is).

    The native single-pass packer on `threads` threads when the library
    is built and rows and out are C-contiguous; otherwise the numpy form:
    for each 8-value group (one little-endian u64 word u), bit j of each
    byte collects into one output byte as
    ((u >> j) & 0x0101..) * 0x0102040810204080 >> 56 (the SWAR gather,
    equal to np.packbits(bitorder="little")). scratch: an optional dict
    that keeps the numpy form's index and word temporaries between calls."""
    s, r = rows.shape
    if out is None:
        out = np.empty((s, k, r // 8), np.uint8)
    if (fastx.available() and rows.flags.c_contiguous
            and out.flags.c_contiguous):
        return fastx.pack_bitplanes(rows, lut256, k, out, threads)
    if scratch is None:
        scratch = {}
    idx = scratch.get("idx")
    if idx is None or idx.shape[0] < s or idx.shape[1] != r:
        idx = scratch["idx"] = np.empty((s, r), np.uint8)
        scratch["tmp"] = np.empty((s, r // 8), np.uint64)
    tmp = scratch["tmp"][:s]
    iv = idx[:s]
    np.take(lut256, rows, out=iv)
    u = iv.view(np.uint64)
    m1 = np.uint64(0x0101010101010101)
    m2 = np.uint64(0x0102040810204080)
    for j in range(k):
        np.right_shift(u, np.uint64(j), out=tmp)
        np.bitwise_and(tmp, m1, out=tmp)
        np.multiply(tmp, m2, out=tmp)
        np.right_shift(tmp, np.uint64(56), out=tmp)
        out[:, j] = tmp  # narrowing copy to uint8
    return out


def gather_pack_rows(bank, rows, lut256, k, out=None, scratch=None,
                     threads=None):
    """pack_rows of bank[rows] without a gathered slab: the native fused
    gather + pack reads each bank row once, on `threads` threads; without
    the library (or for a bank or out that is not C-contiguous) np.take
    into scratch["gather"], then pack_rows (the same bytes)."""
    if out is None:
        out = np.empty((len(rows), k, bank.shape[1] // 8), np.uint8)
    if (fastx.available() and bank.flags.c_contiguous
            and out.flags.c_contiguous):
        return fastx.gather_pack_bitplanes(bank, rows, lut256, k, out,
                                           threads)
    if scratch is None:
        scratch = {}
    ga = scratch.get("gather")
    if ga is None or ga.shape[0] < len(rows) or ga.shape[1] != bank.shape[1]:
        ga = scratch["gather"] = np.empty((len(rows), bank.shape[1]),
                                          np.uint8)
    np.take(bank, rows, axis=0, out=ga[: len(rows)])
    return pack_rows(ga[: len(rows)], lut256, k, out=out, scratch=scratch,
                     threads=threads)


def _unpack_rows_plain(out, packed, table, i0, k):
    """Plain PyTorch version of the unpack kernel, the JAX unpack_place op
    for op: the index bits regrouped by a broadcast shift and mask, the
    registers taken from the table, placed at out[i0:i0 + S] in place."""
    s, _, r8 = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    idx = torch.zeros((s, r8 * 8), dtype=torch.uint8, device=packed.device)
    for j in range(k):
        bits = (packed[:, j, :, None] >> shifts) & 1
        idx = idx | (bits.reshape(s, r8 * 8) << j)
    out[i0:i0 + s] = table[idx.long()]
    return out


def unpack_rows(out, packed, table, i0, k):
    """Decode (S, k, R/8) uint8 bit-planes into out[i0:i0 + S] of a uint8
    (N, R) tensor, in place; returns out. table: uint8 (2^k,) index ->
    value (plan_pack's), on out's device.

    CPU tensors run _unpack_rows_plain. A CUDA out, contiguous, launches
    the hand-written kernel (csrc/regpack_unpack.cu) on the current
    stream, or raises; there is no fallback. The kernel's host code picks
    its path by shape and alignment alone (unpack_path): the word path
    (R/8 a multiple of 4, out at row i0 16-byte aligned, the planes 4-byte
    aligned) decodes 32 registers a thread from a 4-byte word of each
    plane, its index bits regrouped by constant shifts and LOP3 masks,
    looked up in the table in shared memory and written as two 16-byte
    stores; the byte path (any other shape) decodes 8 registers a thread
    from a byte of each plane."""
    who = "unpack_rows"
    _check(who, out.dtype == torch.uint8 and out.dim() == 2,
           f"a 2-D uint8 out expected, got {out.dim()}-D {out.dtype}")
    _check(who, packed.dtype == torch.uint8 and packed.dim() == 3,
           f"uint8 (S, k, R/8) planes expected, got {packed.dim()}-D "
           f"{packed.dtype}")
    s, kp, r8 = packed.shape
    _check(who, 1 <= k <= 7 and kp == k, f"k = {k} with {kp} planes")
    _check(who, out.shape[1] == 8 * r8,
           f"rows of {out.shape[1]} registers from planes of {r8} bytes")
    _check(who, 0 <= i0 and i0 + s <= out.shape[0],
           f"rows {i0}..{i0 + s} outside an out of {out.shape[0]} rows")
    _check(who, table.dtype == torch.uint8
           and table.shape == (1 << k,),
           f"a uint8 table of {1 << k} values expected")
    dev = out.device
    _check(who, packed.device == dev and table.device == dev,
           "out, packed and table on different devices")
    if dev.type == "cpu":
        return _unpack_rows_plain(out, packed, table, i0, k)
    _check(who, dev.type == "cuda", f"unsupported device {dev}")
    _check(who, out.is_contiguous() and packed.is_contiguous()
           and table.is_contiguous(), "contiguous tensors expected")
    dst = out.data_ptr() + i0 * out.shape[1]
    _check(who, dst % 8 == 0, "out not 8-byte aligned")
    if s and r8:
        _launch("regpack_unpack", dev, packed.data_ptr(), s, r8, k,
                table.data_ptr(), dst)
        unpack_rows.launches += 1
    return out


unpack_rows.launches = 0


def unpack_path(out, packed, i0):
    """"word" or "byte": the path that the unpack kernel's host code
    (csrc/regpack_unpack.cu, word_path) takes for unpack_rows(out, packed,
    table, i0, k) on CUDA tensors, asked of the kernel library itself."""
    fn = _build.library("regpack_unpack").csc_regpack_unpack_word_path
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dst = out.data_ptr() + i0 * out.shape[1]
    return "word" if fn(packed.shape[2], packed.data_ptr(), dst) else "byte"
