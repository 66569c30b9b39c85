"""SuperMinHash sketch model, reference-format compatible. Port of
cuda_selection_criteria_tpu/models/smh.py: capability parity with
sketch::SuperMinHash<> as the reference exercises it (construct, addh,
the h_ vector, serialization - sketch/include/sketch/bbmh.h:531-755),
built with the min-reduce formulation of ops/smh_build.
"""

import numpy as np
import torch

from ..ops import kmers as kmer_ops
from ..ops import smh_build
from ..utils import formats
from ..utils.device import as_tensor, u64_numpy

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def vecsize(arg):
    """SizePow2Policy::arg2vecsize: next power of two of arg
    (reference: sketch/include/sketch/policy.h:15-19)."""
    arg = int(arg)
    if arg <= 1:
        return 1
    return 1 << (arg - 1).bit_length()


class SuperMinHashSketch:
    """One genome's SuperMinHash bucket vector h_ (m uint64 buckets, host
    numpy)."""

    def __init__(self, m, h=None):
        self.m = vecsize(m)
        if h is None:
            h = np.full(self.m, U64_MAX, np.uint64)
        h = np.asarray(h, np.uint64)
        if h.size != self.m:
            raise ValueError("bucket count mismatch")
        self.h = h

    @classmethod
    def from_kmers(cls, kmer_arr, m, valid=None, device=None):
        """Build from canonical uint64 k-mers on `device` (default CUDA)."""
        kms = as_tensor(kmer_arr, torch.int64, device)
        if valid is None:
            valid = torch.ones(kms.shape, dtype=torch.bool, device=kms.device)
        mv = vecsize(m)
        zeros = torch.zeros(kms.shape, dtype=torch.int64, device=kms.device)
        h = smh_build.smh_build_batch(kms, valid, zeros, mv, 1, kms.device)
        return cls(mv, u64_numpy(h[0]))

    @classmethod
    def from_codes(cls, codes, m, k=31, device=None):
        """Build from a 2-bit base-code stream (utils/fasta encoding)."""
        kms, valid = kmer_ops.canonical_kmers(codes, k, device)
        return cls.from_kmers(kms, m, valid, kms.device)

    @classmethod
    def from_file(cls, path):
        h = formats.read_smh(path)
        return cls(h.size, h)

    def merge(self, other):
        """Combining two streams == element-wise bucket min."""
        return SuperMinHashSketch(self.m, np.minimum(self.h, other.h))

    def write(self, path):
        formats.write_smh(path, self.h)

    def __eq__(self, other):
        return self.m == other.m and np.array_equal(self.h, other.h)
