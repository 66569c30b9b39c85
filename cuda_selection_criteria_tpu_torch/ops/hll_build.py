"""Batched HyperLogLog register construction, as torch ops. Port of
cuda_selection_criteria_tpu/ops/hll_build.py.

The reference updates one register per hashed k-mer with a compare-and-swap
max loop (reference: sketch/include/sketch/hll.h:886-899):

    index = hash >> (64 - p)
    rank  = clz(((hash << 1) | 1) << (p - 1)) + 1
    core[index] = max(core[index], rank)

Max is associative, commutative and idempotent, so the whole build is one
scatter-max over a batch of hashed k-mers, deterministic whatever order
the device applies it in.
"""

import torch

from ..utils.device import as_tensor
from .hashes import _srl, clz64, wang_hash64


def hll_index_rank(hashed, p, device=None):
    """(register index int64, rank int32) for 64-bit hash values at
    precision p."""
    hashed = as_tensor(hashed, torch.int64, device)
    idx = _srl(hashed, 64 - p)
    rank = clz64(((hashed << 1) | 1) << (p - 1), hashed.device) + 1
    return idx, rank


def hll_build_hashed(hashed, valid, genome_ids, p, n_genomes):
    """uint8 (n_genomes, 2^p) registers from already-hashed k-mers (on the
    device of `hashed`): one int32 scatter-max, invalid positions into a
    scrap slot at the end."""
    m = 1 << p
    idx, rank = hll_index_rank(hashed, p, hashed.device)
    flat = torch.where(valid, genome_ids.to(torch.int64) * m + idx,
                       n_genomes * m)
    regs = torch.zeros(n_genomes * m + 1, dtype=torch.int32,
                       device=hashed.device)
    regs.scatter_reduce_(0, flat, rank, "amax", include_self=True)
    return regs[:n_genomes * m].to(torch.uint8).reshape(n_genomes, m)


def hll_build_batch(kmers, valid, genome_ids, p, n_genomes, device=None):
    """Build HLL register banks for a batch of genomes in one scatter.

    kmers: (M,) canonical k-mers (pre-hash, uint64 values); valid: bool
    (M,); genome_ids: (M,) genome index per k-mer in [0, n_genomes).
    Returns uint8 (n_genomes, 2^p)."""
    kmers = as_tensor(kmers, torch.int64, device)
    dev = kmers.device
    return hll_build_hashed(wang_hash64(kmers, dev),
                            as_tensor(valid, torch.bool, dev),
                            as_tensor(genome_ids, torch.int64, dev), p,
                            n_genomes)


def hll_merge_max(core_a, core_b):
    """Element-wise max merge of two register banks (union sketch)."""
    return torch.maximum(core_a, core_b)


def hll_update(core, kmers, valid, p, device=None):
    """Fold a new batch of k-mers into an existing single-genome register
    set: max-merge of per-batch banks equals the sequential build."""
    kmers = as_tensor(kmers, torch.int64, device)
    zeros = torch.zeros(kmers.shape, dtype=torch.int64, device=kmers.device)
    batch = hll_build_batch(kmers, valid, zeros, p, 1, kmers.device)[0]
    return torch.maximum(as_tensor(core, torch.uint8, kmers.device), batch)
