"""Certified screen: harmonic sums of pairwise HLL unions (kernel K1).

Port of cuda_selection_criteria_tpu/ops/screen.py. With
CDF[v] = #{r : max(a_r, b_r) <= v} over the sorted present register values
b_0 < ... < b_{K-1}, the dyadic telescope gives

    S = R * 2^-b_{K-1} + sum_{k<K-1} (2^-b_k - 2^-b_{k+1}) * CDF[b_k],
    Z = CDF[0]   (when 0 is present),

and the screen keeps a pair when the certified MLE lower bound
t_lb = 2m(m-Z)/(3S-Z) cannot exclude J >= tau (DESIGN.md "Screen
certificate"). screen_hits_fused runs the hand-written CUDA kernel
(csrc/screen_fused.cu) on CUDA tensors and its plain PyTorch version on
CPU tensors; the plain version is also the kernel's reference on the card.
"""

import numpy as np
import torch

from . import _build


def bank_values(regs, chunk=1 << 24):
    """Sorted tuple of the distinct register values present in a uint8
    bank (numpy array, or tensor on any device - the screened engine scans
    its device copy). One CDF bin per PRESENT value: an absent bin folds
    into its predecessor's weight exactly."""
    flat = torch.as_tensor(regs).reshape(-1)
    if flat.dtype != torch.uint8:
        raise ValueError(f"bank_values: uint8 registers expected, got "
                         f"{flat.dtype}")
    counts = torch.zeros(256, dtype=torch.int64, device=flat.device)
    for c0 in range(0, flat.numel(), chunk):
        counts += torch.bincount(flat[c0:c0 + chunk].to(torch.int32),
                                 minlength=256)
    return tuple(torch.nonzero(counts).view(-1).tolist())


FP_BAND_LOG2 = 8  # the reference's default truncation band


def truncate_values(values, max_card, p):
    """Drop telescope bins above v_c = ceil(log2(max_card/m)) + 1 +
    FP_BAND_LOG2 - a one-sided screen speedup: the closed-form tail counts
    every register above the last kept value as that value, so S is
    OVERESTIMATED, which only adds candidates the exact confirmation
    absorbs."""
    m = 1 << p
    v_c = int(np.ceil(np.log2(max(float(max_card), 1.0) / m))
              ) + 1 + FP_BAND_LOG2
    kept = tuple(v for v in values if v <= v_c)
    if len(kept) < 1:
        return tuple(values[:1])
    return kept


def mle_lower_bound(s, z, p):
    """Certified lower bound t_lb = 2m(m - z)/(3s - z) <= t_mle of the
    ERTL-MLE union cardinality from (S, Z); z=None means no zero
    registers anywhere (0 absent from the present values). s and z are
    float32 tensors; every division is tensor / tensor, because torch
    evaluates scalar / tensor as scalar * reciprocal(tensor)."""
    m = float(np.float32(1 << p))
    if z is None:
        return torch.full_like(s, 2.0 * m * m) / (3.0 * s)
    return 2.0 * m * (m - z) / (3.0 * s - z)


def telescope(p, values):
    """(sorted values, f32 bin weights, f32 tail, want_z) of the telescope:
    w_k = 2^-b_k - 2^-b_{k+1} for k < K-1, tail = 2^p * 2^-b_{K-1}."""
    values = tuple(sorted(values))
    weights = [np.float32(np.ldexp(1.0, -b) - np.ldexp(1.0, -values[i + 1]))
               for i, b in enumerate(values[:-1])]
    tail = np.float32(np.ldexp(float(1 << p), -values[-1]))
    return values, weights, tail, values[0] == 0


def _cdf_sum(a, b, thresholds, weights, want_z):
    """(S - tail, Z) of one tile: one f32 indicator matmul per bin, added
    as s = s + w_k * CDF_k in ascending order - the order of the reference's
    _weighted_cdf_sum_jnp. Indicator products are exact integers
    (<= 2^p <= 2^24) in any summation order."""
    s = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32,
                    device=a.device)
    z = None
    for k, (v, w) in enumerate(zip(thresholds, weights)):
        d = (a <= v).to(torch.float32) @ (b <= v).to(torch.float32).T
        s = s + float(w) * d
        if k == 0 and want_z:
            z = d
    return s, z


def screen_s_z(regs, row_tiles, col_tiles, p, values, ti=512, tj=512):
    """Pairwise harmonic sums / zero counts for a list of (row, col) tiles,
    plain PyTorch: (S, Z) float32 (T, ti, tj); Z is None when 0 is not a
    present value. A single present value makes S and Z constants."""
    values, weights, tail, want_z = telescope(p, values)
    if not weights:
        shape = (len(row_tiles), ti, tj)
        s = torch.full(shape, float(tail), dtype=torch.float32,
                       device=regs.device)
        z = (torch.full(shape, float(1 << p), dtype=torch.float32,
                        device=regs.device) if want_z else None)
        return s, z
    s_out, z_out = [], []
    for r, c in zip(row_tiles.tolist(), col_tiles.tolist()):
        s, z = _cdf_sum(regs[r * ti:(r + 1) * ti],
                        regs[c * tj:(c + 1) * tj], values[:-1],
                        weights, want_z)
        s_out.append(s + float(tail))
        z_out.append(z)
    return torch.stack(s_out), (torch.stack(z_out) if want_z else None)


def tile_ids(row_tiles, col_tiles, ti):
    """Global (row ids, col ids), each int64 (T, ti), of a tile list."""
    lane = torch.arange(ti, device=row_tiles.device)
    return (row_tiles.to(torch.int64)[:, None] * ti + lane,
            col_tiles.to(torch.int64)[:, None] * ti + lane)


def band_hit(fp, ii, jj, n_bands):
    """bool (T, ti, ti): some LSH band fingerprint of row i equals row j's."""
    fp_a = fp[ii]  # (T, ti, n_bands) int32
    fp_b = fp[jj]
    hit = fp_a[:, :, None, 0] == fp_b[:, None, :, 0]
    for band in range(1, n_bands):
        hit |= fp_a[:, :, None, band] == fp_b[:, None, :, band]
    return hit


def _fused_gates(row_tiles, col_tiles, e, fp, n_real, tau_scr, tau_cb, ti,
                 n_bands, use_cb, use_smh):
    """(e'_rows, e'_cols, gates) of the fused screen, comparison for
    comparison as the reference's _fused_gates: e' = e/(1+tau_scr) in f32,
    then triangle, n_real tail, empty columns, CB and LSH bands."""
    ii, jj = tile_ids(row_tiles, col_tiles, ti)
    one_tau = np.float32(1.0) + np.float32(tau_scr)
    e32 = e.to(torch.float32)
    # tensor / tensor: a CUDA division by a scalar multiplies by its
    # reciprocal, which rounds differently from the kernel's __fdiv_rn
    e_p = e32 / torch.full_like(e32, float(one_tau))
    e_r = e_p[ii]
    e_c = e_p[jj]
    g = (ii[:, :, None] < jj[:, None, :]) & (jj[:, None, :] < n_real)
    g &= e_c[:, None, :] > 0
    if use_cb:
        g &= e_r[:, :, None] >= float(np.float32(tau_cb)) * e_c[:, None, :]
    if use_smh:
        g &= band_hit(fp, ii, jj, n_bands)
    return e_r, e_c, g


def _screen_hits_fused_plain(regs, row_tiles, col_tiles, e, fp, n_real,
                             tau_scr, tau_cb, p, values, ti, n_bands, use_cb,
                             use_smh):
    """Plain PyTorch version of K1 (the reference's _screen_fused_call +
    _fused_gates): (int8 hits (T, ti, ti), int32 counts (T,))."""
    values, weights, tail, want_z = telescope(p, values)
    if len(values) < 2:
        raise ValueError("the fused screen needs >= 2 present values")
    m_f = np.float32(1 << p)
    two_m = float(np.float32(2.0) * m_f)
    two_m2 = float(np.float32(2.0) * m_f * m_f)
    e_r, e_c, g = _fused_gates(row_tiles, col_tiles, e, fp, n_real, tau_scr,
                               tau_cb, ti, n_bands, use_cb, use_smh)
    hits = torch.empty((len(row_tiles), ti, ti), dtype=torch.int8,
                       device=regs.device)
    for t, (r, c) in enumerate(zip(row_tiles.tolist(), col_tiles.tolist())):
        s, z = _cdf_sum(regs[r * ti:(r + 1) * ti], regs[c * ti:(c + 1) * ti],
                        values[:-1], weights, want_z)
        s = s + float(tail)
        e_sum = e_r[t][:, None] + e_c[t][None, :]
        if want_z:
            h = (3.0 * s - z) * e_sum >= two_m2 - two_m * z
        else:
            h = 3.0 * s * e_sum >= two_m2
        hits[t] = (h & g[t]).to(torch.int8)
    return hits, hits.sum((1, 2), dtype=torch.int32)


def _check(cond, msg):
    if not cond:
        raise ValueError(f"screen_hits_fused: {msg}")


def screen_hits_fused(regs, row_tiles, col_tiles, e, fp, n_real, tau_scr,
                      tau_cb, p, values, ti, n_bands, use_cb, use_smh):
    """Fused screen over a (row, col) tile list: (int8 hits (T, ti, ti),
    int32 counts (T,)).

    CPU tensors run _screen_hits_fused_plain. CUDA tensors launch the
    hand-written kernel (csrc/screen_fused.cu) on the current stream or
    raise; there is no fallback. Needs >= 2 present values.

    Args:
      regs: uint8 (N_pad, 2^p) sorted, padded register bank.
      row_tiles, col_tiles: int32 (T,) block indices in units of ti rows.
      e: float32 (N_pad,) truncated cardinalities (0 on padded rows).
      fp: int32 (N_pad, n_bands) LSH band fingerprints (read if use_smh).
      n_real: number of real (unpadded) rows.
      tau_scr, tau_cb: f32 screen and CB thresholds.
      values: sorted present register values (screen truncation applied).
    """
    if regs.device.type == "cpu":
        return _screen_hits_fused_plain(regs, row_tiles, col_tiles, e, fp,
                                        n_real, tau_scr, tau_cb, p, values,
                                        ti, n_bands, use_cb, use_smh)
    dev = regs.device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    values, weights, tail, want_z = telescope(p, values)
    r = 1 << p
    n_tiles = int(row_tiles.shape[0])
    _check(len(values) >= 2, "needs >= 2 present values")
    _check(0 <= values[0] and values[-1] <= 255, "values outside uint8")
    _check(regs.dtype == torch.uint8 and regs.dim() == 2
           and regs.is_contiguous() and regs.shape[1] == r,
           "regs must be contiguous uint8 (N_pad, 2^p)")
    _check(r % 32 == 0 and regs.data_ptr() % 16 == 0,
           "needs p >= 5 and a 16-byte aligned bank")
    _check(ti % 64 == 0 and regs.shape[0] % ti == 0,
           "ti must be a multiple of 64 dividing N_pad")
    _check(0 < n_tiles <= 65535, "1..65535 tiles per launch")
    for name, x in (("row_tiles", row_tiles), ("col_tiles", col_tiles)):
        _check(x.device == dev and x.dtype == torch.int32
               and x.shape == (n_tiles,) and x.is_contiguous(),
               f"{name} must be contiguous int32 (T,) on {dev}")
    _check(e.device == dev and e.dtype == torch.float32
           and e.shape == (regs.shape[0],) and e.is_contiguous(),
           "e must be contiguous float32 (N_pad,)")
    _check(fp.device == dev and fp.dtype == torch.int32
           and fp.shape == (regs.shape[0], n_bands) and fp.is_contiguous(),
           "fp must be contiguous int32 (N_pad, n_bands)")

    nbins = len(weights)
    thr = torch.tensor(values[:-1], dtype=torch.int32, device=dev)
    w = torch.tensor(np.asarray(weights, np.float32), device=dev)
    planes = torch.empty((regs.shape[0], nbins, r // 32), dtype=torch.int32,
                         device=dev)
    hits = torch.empty((n_tiles, ti, ti), dtype=torch.int8, device=dev)
    counts = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    m_f = np.float32(r)
    one_tau = np.float32(1.0) + np.float32(tau_scr)
    err = _build.library().csc_screen_fused(
        regs.data_ptr(), regs.shape[0], r, thr.data_ptr(), w.data_ptr(),
        nbins, float(tail), int(want_z), float(np.float32(2.0) * m_f),
        float(np.float32(2.0) * m_f * m_f), planes.data_ptr(),
        row_tiles.data_ptr(), col_tiles.data_ptr(), n_tiles, ti,
        e.data_ptr(), float(one_tau), fp.data_ptr(), n_bands, int(n_real),
        float(np.float32(tau_cb)), int(use_cb), int(use_smh),
        hits.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"screen_fused kernel launch failed: "
                           f"cudaError_t {err}")
    screen_hits_fused.launches += 1
    return hits, counts


screen_hits_fused.launches = 0
