"""HyperLogLog sketch model, reference-format compatible. Port of
cuda_selection_criteria_tpu/models/hll.py: capability parity with
sketch::hll_t as the reference exercises it (construct, addh, report,
union_size, write, read - sketch/include/sketch/hll.h), with construction
as a device scatter (ops/hll_build) and estimation through the host f64
oracle (utils/hostref; the device estimators are ROADMAP.md queue 1,
item 9).
"""

import numpy as np
import torch

from ..ops import hll_build
from ..ops import kmers as kmer_ops
from ..utils import formats, hostref
from ..utils.device import as_tensor


class HllSketch:
    """One genome's HLL register array at precision p (2^p uint8 registers,
    host numpy)."""

    def __init__(self, p, core=None):
        self.p = int(p)
        if core is None:
            core = np.zeros(1 << self.p, np.uint8)
        core = np.asarray(core, np.uint8)
        if core.size != (1 << self.p):
            raise ValueError("register count does not match precision")
        self.core = core
        self._card = None

    @classmethod
    def from_kmers(cls, kmer_arr, p, valid=None, device=None):
        """Build from canonical uint64 k-mers on `device` (default CUDA)."""
        kms = as_tensor(kmer_arr, torch.int64, device)
        if valid is None:
            valid = torch.ones(kms.shape, dtype=torch.bool, device=kms.device)
        zeros = torch.zeros(kms.shape, dtype=torch.int64, device=kms.device)
        regs = hll_build.hll_build_batch(kms, valid, zeros, p, 1, kms.device)
        return cls(p, regs[0].cpu().numpy())

    @classmethod
    def from_codes(cls, codes, p, k=31, device=None):
        """Build from a 2-bit base-code stream (utils/fasta encoding)."""
        kms, valid = kmer_ops.canonical_kmers(codes, k, device)
        return cls.from_kmers(kms, p, valid, kms.device)

    @classmethod
    def from_file(cls, path):
        p, core, _ = formats.read_hll(path)
        return cls(p, core)

    def report(self):
        """ERTL-MLE cardinality estimate (reference: hll.h:834-864), host
        f64."""
        if self._card is None:
            self._card = float(hostref.ertl_mle_batch(
                hostref.histogram(self.core)[None, :], self.p)[0])
        return self._card

    def union_size(self, other):
        """Union cardinality with another sketch (reference:
        hll.h:1188-1210), host f64."""
        if self.p != other.p:
            raise ValueError("precision mismatch")
        return float(hostref.union_size(self.core, other.core, self.p))

    def jaccard(self, other):
        t = self.union_size(other)
        e1, e2 = int(self.report()), int(other.report())
        return (e1 + e2 - t) / t

    def merge(self, other):
        """Union sketch: element-wise register max."""
        return HllSketch(self.p, np.maximum(self.core, other.core))

    def write(self, path):
        formats.write_hll(path, self.p, self.core)

    def __eq__(self, other):
        return self.p == other.p and np.array_equal(self.core, other.core)
