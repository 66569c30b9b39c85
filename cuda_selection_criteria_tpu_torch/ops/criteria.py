"""Selection-criteria constants (include/criteria_sketch.hpp), host numpy.

Mixed f32/f64 arithmetic mirrors the reference exactly: the threshold is
parsed with std::stof, and sigma() and the Z-score are C floats.
"""

import numpy as np

from .estimators import sigma


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
