"""Vectorized canonical k-mer extraction from 2-bit base-code streams, as
torch ops. Port of cuda_selection_criteria_tpu/ops/kmers.py.

The reference scans each FASTA record base-by-base with a rolling 2k-bit
window, resetting the window at non-ACGT characters and record boundaries
(reference: src/build_sketch.cpp:62-92). That is equivalent to:

    a k-mer ending at position i is valid  <=>  codes[i-k+1 .. i] are all
    valid bases with no reset sentinel in between,

    kmer[i] = sum_{t=0..k-1} codes[i-t] << (2*t)

computed here as k shifted ORs over the whole stream plus a cumulative-sum
validity test. Input encoding (utils/fasta): 0..3 = A,C,G,T, >= 4 = reset.
"""

import torch

from ..utils.device import as_tensor, u64_numpy
from .hashes import canonical_kmer


def kmer_windows(codes, k=31, device=None):
    """All k-length windows of a code stream, with validity mask.

    codes: uint8 (L,) base codes (>= 4 marks a reset); k <= 32.
    Returns (kmers, valid): int64 (L,) packed windows ending at each
    position (uint64 bit patterns) and bool (L,) marking positions whose
    whole window is valid; positions i < k-1 are always invalid."""
    codes = as_tensor(codes, torch.uint8, device)
    dev = codes.device
    length = codes.shape[0]
    ok = codes < 4
    c64 = torch.where(ok, codes, 0).to(torch.int64)

    # kmer[i] = sum_t c64[i-t] << (2t); out-of-range reads are zero-padded.
    padded = torch.cat([torch.zeros(k - 1, dtype=torch.int64, device=dev),
                        c64])
    acc = torch.zeros(length, dtype=torch.int64, device=dev)
    for t in range(k):
        acc |= padded[k - 1 - t:k - 1 - t + length] << (2 * t)

    cbad = torch.cumsum((~ok).to(torch.int32), 0, dtype=torch.int32)
    # window [i-k+1, i] has no bad base <=> cbad[i] - cbad[i-k] == 0
    cbad_shift = torch.cat([torch.zeros(k, dtype=torch.int32, device=dev),
                            cbad])[:length]
    valid = (cbad - cbad_shift) == 0
    valid &= torch.arange(length, device=dev) >= k - 1
    return acc, valid


def canonical_kmers(codes, k=31, device=None):
    """Canonical (strand-independent) k-mers of a code stream + validity."""
    kms, valid = kmer_windows(codes, k, device)
    return canonical_kmer(kms, k, kms.device), valid


def canonical_kmers_np(codes, k=31, device=None):
    """Host-side convenience: the valid canonical k-mers of a code stream,
    compacted, as a numpy uint64 array (the reference's numpy oracle)."""
    kms, valid = canonical_kmers(codes, k, device)
    return u64_numpy(kms[valid])
