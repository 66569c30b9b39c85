"""Selection criteria (include/criteria_sketch.hpp): host constants and
the dense engine's pair-block masks. Port of
cuda_selection_criteria_tpu/ops/criteria.py.

  * CB      - gamma = |A|/|B| >= tau               (criteria_sketch.hpp:45-49)
  * hll_a   - K+ bound from aux-HLL union          (criteria_sketch.hpp:36-43,60-64)
  * hll_an  - order-n corrected Jaccard bound      (criteria_sketch.hpp:22-34,52-58)
  * smh_a   - LSH banding over SuperMinHash h_     (criteria_sketch.hpp:66-81)

Mixed f32/f64 arithmetic mirrors the reference exactly: the threshold is
parsed with std::stof, and sigma() and the Z-score are C floats. The masks
keep the JAX twin's dtypes: tau and zs are f64 scalars there, so with an
f32 MLE the terms that meet them are widened to f64 (`_f64`).
Cardinalities are pre-truncated to integers by the caller (size_t).
"""

import numpy as np
import torch

from .estimators import ertl_mle, sigma
from .pairwise import union_histograms


def effective_tau(tau):
    """The threshold as the reference sees it: parsed with std::stof
    (f32) then promoted to double (src/selection.cpp:103)."""
    return np.float64(np.float32(tau))


def z_sigma(z_score, p):
    """f64(f32(Z) * f32(sigma(p))) - the reference's float product, widened."""
    return np.float64(np.float32(z_score) * sigma(p))


def zs_series(zs, order_n):
    """s = sum_{k=1..order_n} zs^k of the hll_an correction, accumulated
    term by term as the reference does (criteria_sketch.hpp:52-58)."""
    s = 0.0
    num = 1.0
    for _ in range(order_n):
        num *= zs
        s += num
    return s


def smh_band_params(m, tau):
    """Band/row split: smallest divisor band count with P_r >= 0.95.

    Matches src/selection.cpp:258-267 including the float/double mixing in
    P_r and the fallback to (n_rows=1, n_bands=m) when no divisor reaches
    the target.
    """
    n_rows, n_bands = 1, 1
    tau32 = np.float32(tau)
    for band in range(1, m + 1):
        if m % band:
            continue
        n_bands, n_rows = band, m // band
        inner = np.power(tau32, np.float32(m) / np.float32(band))  # float pow
        p_r = 1.0 - np.power(np.float64(1.0) - np.float64(inner),
                             np.float64(np.float32(band)))
        if p_r >= 0.95:
            break
    return n_rows, n_bands


def _f64(x):
    return x.to(torch.float64)


def cb_mask(cards_a, cards_b, tau):
    """Cardinality-bound mask: gamma = e1/e2 >= tau (cards sorted: e1 <=
    e2), in f64. cards_*: tensors; tau: a float."""
    e1 = _f64(cards_a)[:, None]
    e2 = _f64(cards_b)[None, :]
    return (e1 / e2) >= tau


def smh_a_mask(aux_a, aux_b, n_rows, n_bands):
    """LSH banding mask: any contiguous band of n_rows buckets fully equal.
    aux_*: (Bi, m) / (Bj, m) SuperMinHash buckets, uint64 bit patterns in
    int64 (equality is sign-safe)."""
    eq = aux_a[:, None, :] == aux_b[None, :, :]  # (Bi, Bj, m)
    eq = eq.reshape(eq.shape[0], eq.shape[1], n_bands, n_rows)
    return eq.all(-1).any(-1)


def hll_a_mask(aux_regs_a, aux_regs_b, cards_a, cards_b, tau, zs, p_aux,
               precision="bf16", mle_dtype=torch.float64):
    """K+ bound gate (criteria_sketch.hpp:36-43,60-64) over a pair block.

    t_hat is size_t-truncated like the reference (`size_t t_hat =
    S_A->union_size(...)`, criteria_sketch.hpp:61). zs = z_sigma(Z, p_aux),
    an f64 scalar."""
    counts = union_histograms(aux_regs_a, aux_regs_b, p_aux, precision)
    t_hat = torch.trunc(ertl_mle(counts, p_aux, dtype=mle_dtype))
    e1 = cards_a.to(mle_dtype)[:, None]
    e2 = cards_b.to(mle_dtype)[None, :]
    gamma = e1 / e2
    t_hat_mas = _f64(t_hat) / torch.tensor(
        1.0 + float(zs), dtype=torch.float64, device=t_hat.device)
    k_mas = (_f64((1.0 + gamma) * e2) - t_hat_mas) / t_hat_mas
    return k_mas >= tau


def hll_an_mask(aux_regs_a, aux_regs_b, cards_a, cards_b, tau, zs, p_aux,
                order_n=1, precision="bf16", mle_dtype=torch.float64):
    """Order-n corrected Jaccard gate (criteria_sketch.hpp:22-34,52-58).

    t_hat stays unrounded here (hll_an takes `double t_hat`). The series
    s = sum zs^k is f64 whatever mle_dtype is (zs is an f64 scalar)."""
    counts = union_histograms(aux_regs_a, aux_regs_b, p_aux, precision)
    t_hat = ertl_mle(counts, p_aux, dtype=mle_dtype)
    e1 = cards_a.to(mle_dtype)[:, None]
    e2 = cards_b.to(mle_dtype)[None, :]
    gamma = e1 / e2
    j_hat = (e1 + e2 - t_hat) / t_hat
    s = zs_series(float(zs), order_n)
    one = torch.ones((), dtype=torch.float64, device=t_hat.device)
    minimo = torch.minimum(one, ((1.0 + float(zs)) * _f64(e2)) / _f64(t_hat))
    c = (minimo * _f64(1.0 + gamma)) * s
    return (_f64(j_hat) + c) >= tau
