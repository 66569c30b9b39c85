"""HyperLogLog estimator helpers.

The ERTL-MLE itself runs on the host in true f64
(utils/hostref.ertl_mle_batch); the device only counts registers.
"""

import numpy as np
import torch


def hll_histogram(regs, p):
    """Register-value histogram c[v] = #{r : regs[r] == v} per row.

    regs: integer tensor (B, m) with values <= q+1 (q = 64 - p), which
    every HLL register satisfies. Returns int64 (B, q+2) exact counts.

    Counted with per-row offsets and one bincount: the JAX twin's one-hot
    (cuda_selection_criteria_tpu/ops/estimators.py:64-74) would
    materialize B x m x (q+2) booleans - 7 GB for one 8192-pair confirm
    chunk at p=14. int32 offsets are exact up to B*(q+2) < 2^31.
    """
    nbins = 64 - p + 2
    b = regs.shape[0]
    off = (torch.arange(b, dtype=torch.int32, device=regs.device)
           * nbins)[:, None]
    flat = (regs.to(torch.int32) + off).reshape(-1)
    return torch.bincount(flat, minlength=b * nbins).reshape(b, nbins)


def make_alpha(m):
    """HLL alpha constant (reference: hll.h:755-762)."""
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def sigma(p):
    """HLL standard-error table, f32 like the reference
    (include/criteria_sketch.hpp:7-20)."""
    if p == 4:
        v = 1.106 / np.sqrt(np.float64(1 << p))
    elif p == 5:
        v = 1.07 / np.sqrt(np.float64(1 << p))
    elif p == 6:
        v = 1.054 / np.sqrt(np.float64(1 << p))
    elif p == 7:
        v = 1.046 / np.sqrt(np.float64(1 << p))
    else:
        v = 1.039 / np.sqrt(np.float64(1 << p))
    return np.float32(v)
