"""Pairwise HLL-union histograms and Jaccard estimates as indicator
products. Port of cuda_selection_criteria_tpu/ops/pairwise.py.

The cumulative histogram of the max-merged registers of rows i and j
factorizes over the register axis r:

    CDF[i,j,v] = #{r : max(a_ir, b_jr) <= v} = sum_r [a_ir <= v] * [b_jr <= v]

so each value v is one (Bi, R) x (R, Bj) product of 0/1 indicator
matrices, exact in integers (sums <= R = 2^p < 2^24). The histogram is the
first difference of the CDF along v and feeds the batched ERTL-MLE. The
JAX package computes the products with XLA's dot_general; here they are
torch._int_mm on int8 indicators ("int8") or a float32 matmul ("bf16",
the reference's name for its bf16-in, f32-accumulate route: torch's bf16
matmul returns bf16, which would round counts above 256, while 0 and 1 are
exact in TF32 and f32 sums stay exact below 2^24). Both routes give the
same integers.
"""

import torch
import torch.nn.functional as F

from .estimators import ertl_mle


def _round_up(n, k):
    return -(-n // k) * k


def _indicator_product(regs_a, regs_b, v, precision):
    """(Bi, Bj) counts #{r : a_ir <= v and b_jr <= v}."""
    bi, r = regs_a.shape
    bj = regs_b.shape[0]
    if precision == "int8":
        # torch._int_mm wants more than 16 rows and inner and column sizes
        # in multiples of 8 (CUDA): zero indicators pad all three and the
        # padding is sliced off, so every shape takes this route.
        rows, inner, cols = max(24, _round_up(bi, 8)), _round_up(r, 8), \
            _round_up(bj, 8)
        ia = F.pad((regs_a <= v).to(torch.int8), (0, inner - r, 0, rows - bi))
        ib = F.pad((regs_b <= v).to(torch.int8), (0, inner - r, 0, cols - bj))
        return torch._int_mm(ia, ib.t())[:bi, :bj]
    return ((regs_a <= v).to(torch.float32)
            @ (regs_b <= v).to(torch.float32).t())


def cdf_matmul(regs_a, regs_b, p, precision="bf16"):
    """Partial CDF sums: out[i,j,v] = sum_r [a_ir <= v][b_jr <= v], v < q+1,
    over whatever register slice is passed in (the sum of the slices'
    outputs is the whole's).

    regs_a: uint8 (Bi, R); regs_b: uint8 (Bj, R), on one device.
    Returns float32 (Bi, Bj, q+1), exact."""
    nbins = 64 - p + 2
    # v = 0..nbins-2; the top bin (== R) is appended by counts_from_cdf
    cdf = [_indicator_product(regs_a, regs_b, v, precision)
           for v in range(nbins - 1)]
    return torch.stack(cdf, dim=-1).to(torch.float32)


def counts_from_cdf(cdf, r_total):
    """Histogram from the cumulative sums; r_total is the full register
    count 2^p (the top CDF bin)."""
    top = torch.full(cdf.shape[:-1] + (1,), float(r_total),
                     dtype=torch.float32, device=cdf.device)
    return torch.diff(torch.cat([cdf, top], dim=-1), dim=-1,
                      prepend=torch.zeros_like(top))


def union_histograms(regs_a, regs_b, p, precision="bf16"):
    """float32 (Bi, Bj, q+2) histograms of max(a, b) register values for
    all pairs of two banks (bins 0..q+1, q = 64-p): exact integer counts.
    precision: "int8" (torch._int_mm) or anything else (f32 matmul)."""
    return counts_from_cdf(cdf_matmul(regs_a, regs_b, p, precision),
                           regs_a.shape[-1])


def union_cardinality(regs_a, regs_b, p, precision="bf16",
                      mle_dtype=torch.float64):
    """ERTL-MLE union-cardinality estimates for all pairs of two banks,
    hll_t::union_size (hll.h:1188-1210) on the Bi x Bj grid; `mle_dtype`
    (Bi, Bj), float64 bit-exact."""
    return ertl_mle(union_histograms(regs_a, regs_b, p, precision), p,
                    dtype=mle_dtype)


def pairwise_jaccard(regs_a, regs_b, cards_a, cards_b, p, precision="bf16",
                     mle_dtype=torch.float64):
    """Jaccard estimates J = (e1 + e2 - t) / t for all pairs of two banks.

    cards_*: f64 report() values (tensors), truncated to integers like the
    reference's `size_t e1 = card_name[i].second` (src/selection.cpp:157,
    162) after the cast to mle_dtype. Returns (jacc, t), `mle_dtype`
    (Bi, Bj) each."""
    t = union_cardinality(regs_a, regs_b, p, precision, mle_dtype)
    e1 = torch.trunc(cards_a.to(mle_dtype))[:, None]
    e2 = torch.trunc(cards_b.to(mle_dtype))[None, :]
    return (e1 + e2 - t) / t, t
