"""Certified screen: harmonic sums of pairwise HLL unions (kernels K1, K2).

Port of cuda_selection_criteria_tpu/ops/screen.py. With
CDF[v] = #{r : max(a_r, b_r) <= v} over the sorted present register values
b_0 < ... < b_{K-1}, the dyadic telescope gives

    S = R * 2^-b_{K-1} + sum_{k<K-1} (2^-b_k - 2^-b_{k+1}) * CDF[b_k],
    Z = CDF[0]   (when 0 is present),

and the screen keeps a pair when the certified MLE lower bound
t_lb = 2m(m-Z)/(3S-Z) cannot exclude J >= tau (DESIGN.md "Screen
certificate"). screen_hits_fused (K1, csrc/screen_fused.cu), its strip
variant screen_hits_fused_strips (the same kernel with rows and columns
from two banks, the ring engine's screen) and screen_s_z (K2, the raw S
and Z; csrc/weighted_cdf_sum.cu) run their hand-written CUDA kernels on
CUDA tensors and their plain PyTorch versions on CPU tensors; each plain
version is also its kernel's reference on the card.
"""

import functools

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


def _launch(name, dev, *args):
    """Calls kernel library `name`'s C entry point with `args` and dev's
    current stream, with dev the current device (a launch and its
    shared-memory attribute go to the current device, which must own the
    stream); raises if the launch failed."""
    with torch.cuda.device(dev):
        err = getattr(_build.library(name), _build.KERNELS[name][0])(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _check(who, cond, msg):
    if not cond:
        raise ValueError(f"{who}: {msg}")


@functools.lru_cache(maxsize=64)
def _device_telescope(device, p, values):
    """(int32 thresholds, f32 weights) of telescope(p, values) as tensors on
    `device`, kept per (device, p, values): K1 and K2 read them at every
    launch, and a host-to-device copy of a few bytes stalls the stream."""
    values, weights, _, _ = telescope(p, values)
    return (torch.tensor(values[:-1], dtype=torch.int32, device=device),
            torch.tensor(np.asarray(weights, np.float32), device=device))


def _constant_s_z(n_tiles, p, tail, want_z, ti, tj, device):
    """S and Z of a bank with a single present value: constants."""
    shape = (n_tiles, ti, tj)
    s = torch.full(shape, float(tail), dtype=torch.float32, device=device)
    z = (torch.full(shape, float(1 << p), dtype=torch.float32, device=device)
         if want_z else None)
    return s, z


def _screen_s_z_plain(regs, row_tiles, col_tiles, p, values, ti, tj,
                      regs_cols=None):
    """Plain PyTorch version of K2 (the reference's _weighted_cdf_sum
    behind screen_s_z): (S, Z) float32 (T, ti, tj); Z is None when 0 is not
    a present value. Rows come from regs, columns from regs_cols (default:
    regs)."""
    if regs_cols is None:
        regs_cols = regs
    values, weights, tail, want_z = telescope(p, values)
    if not weights:
        return _constant_s_z(len(row_tiles), p, tail, want_z, ti, tj,
                             regs.device)
    s_out, z_out = [], []
    for r, c in zip(row_tiles.tolist(), col_tiles.tolist()):
        s, z = _cdf_sum(regs[r * ti:(r + 1) * ti],
                        regs_cols[c * tj:(c + 1) * tj], values[:-1],
                        weights, want_z)
        s_out.append(s + float(tail))
        z_out.append(z)
    return torch.stack(s_out), (torch.stack(z_out) if want_z else None)


def _check_bank(who, regs, dev, r, rows_per_tile, name):
    _check(who, regs.device == dev and regs.dtype == torch.uint8
           and regs.dim() == 2 and regs.is_contiguous()
           and regs.shape[1] == r,
           f"{name} must be contiguous uint8 (N_pad, 2^p) on {dev}")
    _check(who, r % 32 == 0 and regs.data_ptr() % 16 == 0,
           f"needs p >= 5 and a 16-byte aligned {name}")
    _check(who, rows_per_tile % 64 == 0
           and regs.shape[0] % rows_per_tile == 0,
           f"the tile edge of {name} must be a multiple of 64 dividing its "
           "rows")


def _check_tiles(who, row_tiles, col_tiles, dev):
    n_tiles = int(row_tiles.shape[0])
    _check(who, 0 < n_tiles <= 65535, "1..65535 tiles per launch")
    for name, x in (("row_tiles", row_tiles), ("col_tiles", col_tiles)):
        _check(who, x.device == dev and x.dtype == torch.int32
               and x.shape == (n_tiles,) and x.is_contiguous(),
               f"{name} must be contiguous int32 (T,) on {dev}")
    return n_tiles


def screen_s_z(regs, row_tiles, col_tiles, p, values, ti=512, tj=512,
               regs_cols=None):
    """Pairwise harmonic sums / zero counts for a list of (row, col) tiles:
    (S, Z) float32 (T, ti, tj); Z is None when 0 is not a present value.

    A single present value makes S and Z constants (no kernel). Otherwise
    CPU tensors run _screen_s_z_plain, and CUDA tensors launch the
    hand-written kernel K2 (csrc/weighted_cdf_sum.cu: CDF counts as 1-bit
    tensor-core mma over bit-plane rows of plane_row_words(p, nbins) words,
    folded into S bin by bin) on the current stream or raise; there is no
    fallback.

    Args:
      regs: uint8 (N_pad, 2^p) row bank; row_tiles index it in units of ti.
      row_tiles, col_tiles: int32 (T,) block indices.
      values: sorted present register values (a truncate_values prefix
        makes S a one-sided overestimate).
      ti, tj: row and column tile edges (multiples of 64 on CUDA).
      regs_cols: optional separate uint8 (M_pad, 2^p) column bank that
        col_tiles index in units of tj; None means regs.
    """
    values, weights, tail, want_z = telescope(p, values)
    if not weights:
        return _constant_s_z(len(row_tiles), p, tail, want_z, ti, tj,
                             regs.device)
    if regs.device.type == "cpu":
        return _screen_s_z_plain(regs, row_tiles, col_tiles, p, values, ti,
                                 tj, regs_cols)
    who = "screen_s_z"
    dev = regs.device
    _check(who, 0 <= values[0] and values[-1] <= 255, "values outside uint8")
    r = 1 << p
    _check_bank(who, regs, dev, r, ti, "regs")
    if regs_cols is not None:
        _check_bank(who, regs_cols, dev, r, tj, "regs_cols")
    else:
        _check(who, tj % 64 == 0 and regs.shape[0] % tj == 0,
               "tj must be a multiple of 64 dividing N_pad")
    n_tiles = _check_tiles(who, row_tiles, col_tiles, dev)
    _check(who, dev.type == "cuda", f"unsupported device {dev}")

    nbins = len(weights)
    thr, w = _device_telescope(dev, p, values)
    row_words = plane_row_words(p, nbins)
    planes = torch.empty((regs.shape[0], row_words), dtype=torch.int32,
                         device=dev)
    planes_c = (None if regs_cols is None else
                torch.empty((regs_cols.shape[0], row_words),
                            dtype=torch.int32, device=dev))
    s = torch.empty((n_tiles, ti, tj), dtype=torch.float32, device=dev)
    z = torch.empty_like(s) if want_z else None
    _launch("weighted_cdf_sum", dev,
            regs.data_ptr(), regs.shape[0],
            None if regs_cols is None else regs_cols.data_ptr(),
            0 if regs_cols is None else regs_cols.shape[0], r,
            thr.data_ptr(), w.data_ptr(), nbins, float(tail), int(want_z),
            planes.data_ptr(),
            None if planes_c is None else planes_c.data_ptr(), row_words,
            row_tiles.data_ptr(), col_tiles.data_ptr(), n_tiles, ti, tj,
            s.data_ptr(), None if z is None else z.data_ptr())
    screen_s_z.launches += 1
    return s, z


screen_s_z.launches = 0


def tile_ids(row_tiles, col_tiles, ti):
    """Global (row ids, col ids), each int64 (T, ti), of a tile list."""
    lane = torch.arange(ti, device=row_tiles.device)
    return (row_tiles.to(torch.int64)[:, None] * ti + lane,
            col_tiles.to(torch.int64)[:, None] * ti + lane)


def band_hit(fp, ii, jj, n_bands, fp_cols=None):
    """bool (T, ti, ti): some LSH band fingerprint of row i equals row j's.
    Rows index fp, columns fp_cols (default: fp)."""
    fp_a = fp[ii]  # (T, ti, n_bands) int32
    fp_b = (fp if fp_cols is None else fp_cols)[jj]
    hit = fp_a[:, :, None, 0] == fp_b[:, None, :, 0]
    for band in range(1, n_bands):
        hit |= fp_a[:, :, None, band] == fp_b[:, None, :, band]
    return hit


def pair_gates(e_r, e_c, fp_rows, fp_cols, rl, cl, row_base, col_base,
               n_real, tau_cb, n_bands, use_cb, use_smh):
    """bool (T, ti, ti) cheap gates of a tile list over a row strip and a
    column strip: i < j and j < n_real on the global ids row_base + rl and
    col_base + cl, a non-empty column, CB on the gathered cardinalities e_r
    / e_c (T, ti), and LSH bands on the local ids. One bank is the strip
    pair with both sides the same and bases 0."""
    gi = rl + int(row_base)
    gj = cl + int(col_base)
    g = (gi[:, :, None] < gj[:, None, :]) & (gj[:, None, :] < n_real)
    g &= e_c[:, None, :] > 0
    if use_cb:
        g &= e_r[:, :, None] >= float(np.float32(tau_cb)) * e_c[:, None, :]
    if use_smh:
        g &= band_hit(fp_rows, rl, cl, n_bands, fp_cols)
    return g


def _gate_counts_plain(e_rows, e_cols, fp_rows, fp_cols, row_tiles,
                       col_tiles, row_base, col_base, n_real, tau_cb,
                       n_bands, ti, use_cb, use_smh):
    """Plain PyTorch version of the gate-count kernel (the reference's
    _gate_counts / _ring_gate_counts): pair_gates over the tile list, then
    an int32 sum a tile. Holds (T, ti, ti) masks."""
    rl, cl = tile_ids(row_tiles, col_tiles, ti)
    gate = pair_gates(e_rows[rl], e_cols[cl], fp_rows, fp_cols, rl, cl,
                      row_base, col_base, n_real, tau_cb, n_bands, use_cb,
                      use_smh)
    return gate.sum((1, 2), dtype=torch.int32)


GATE_ROWS = 128  # rows of one CTA of csrc/gate_counts.cu (its kRows)


def gate_counts(e_rows, e_cols, fp_rows, fp_cols, row_tiles, col_tiles,
                row_base, col_base, n_real, tau_cb, n_bands, ti, use_cb,
                use_smh):
    """int32 (T,) count of the pairs of each tile that pass the cheap
    gates (the cascade's gate prune): global ids row_base + local row <
    col_base + local column < n_real, a non-empty column, CB (use_cb) and
    some equal LSH band fingerprint (use_smh).

    Row tiles index e_rows and fp_rows, column tiles e_cols and fp_cols,
    in units of ti local rows; one bank is both sides the same with bases
    0. CPU tensors run _gate_counts_plain. CUDA tensors launch the
    hand-written kernel (csrc/gate_counts.cu: one pass over e and fp, no
    mask in device memory) on the current stream or raise; there is no
    fallback.

    Args:
      e_rows, e_cols: float32 (rows,) cardinalities of each side.
      fp_rows, fp_cols: int32 (rows, n_bands) band fingerprints of each
        side (read if use_smh).
      row_tiles, col_tiles: int32 (T,) tile indices.
      tau_cb: f32 CB threshold.
    """
    who = "gate_counts"
    dev = e_rows.device
    n_tiles = int(row_tiles.shape[0])
    for name, e in (("e_rows", e_rows), ("e_cols", e_cols)):
        _check(who, e.device == dev and e.dtype == torch.float32
               and e.dim() == 1 and e.is_contiguous(),
               f"{name} must be contiguous float32 (rows,) on {dev}")
    for name, fp, e in (("fp_rows", fp_rows, e_rows),
                        ("fp_cols", fp_cols, e_cols)):
        _check(who, fp.device == dev and fp.dtype == torch.int32
               and fp.shape == (e.shape[0], n_bands) and fp.is_contiguous(),
               f"{name} must be contiguous int32 (rows, n_bands) on {dev}")
    for name, x in (("row_tiles", row_tiles), ("col_tiles", col_tiles)):
        _check(who, x.device == dev and x.dtype == torch.int32
               and x.shape == (n_tiles,) and x.is_contiguous(),
               f"{name} must be contiguous int32 (T,) on {dev}")
    _check(who, ti >= 1 and n_bands >= 1, "needs ti >= 1 and n_bands >= 1")
    if dev.type == "cpu":
        return _gate_counts_plain(e_rows, e_cols, fp_rows, fp_cols,
                                  row_tiles, col_tiles, row_base, col_base,
                                  n_real, tau_cb, n_bands, ti, use_cb,
                                  use_smh)
    _check(who, dev.type == "cuda", f"unsupported device {dev}")
    _check(who, n_tiles * -(-ti // GATE_ROWS) < 2**31,
           "too many tiles for one launch")
    counts = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    if n_tiles:
        _launch("gate_counts", dev, e_rows.data_ptr(), e_cols.data_ptr(),
                fp_rows.data_ptr(), fp_cols.data_ptr(), n_bands,
                e_rows.shape[0], e_cols.shape[0], row_tiles.data_ptr(),
                col_tiles.data_ptr(), n_tiles, ti, int(n_real),
                int(row_base), int(col_base), float(np.float32(tau_cb)),
                int(use_cb), int(use_smh), counts.data_ptr())
        gate_counts.launches += 1
    return counts


gate_counts.launches = 0


def _strip_gates(r_tiles, c_tiles, e_rows, e_cols, fp_rows, fp_cols,
                 row_base, col_base, n_real, tau_scr, tau_cb, ti, n_bands,
                 use_cb, use_smh):
    """(e'_rows, e'_cols, gates) of the fused screen over a row strip and a
    column strip, comparison for comparison as the reference's
    screen_hits_fused_strips: local tile ids index each side's e and fp,
    e' = e/(1+tau_scr) in f32, then pair_gates on e'. One bank with bases
    0 is the reference's _fused_gates."""
    rl, cl = tile_ids(r_tiles, c_tiles, ti)
    one_tau = float(np.float32(1.0) + np.float32(tau_scr))

    def scaled(e):
        # tensor / tensor: a CUDA division by a scalar multiplies by its
        # reciprocal, which rounds differently from the kernel's __fdiv_rn
        e32 = e.to(torch.float32)
        return e32 / torch.full_like(e32, one_tau)

    ep_rows = scaled(e_rows)
    ep_cols = ep_rows if e_cols is e_rows else scaled(e_cols)
    e_r = ep_rows[rl]
    e_c = ep_cols[cl]
    return e_r, e_c, pair_gates(e_r, e_c, fp_rows, fp_cols, rl, cl, row_base,
                                col_base, n_real, tau_cb, n_bands, use_cb,
                                use_smh)


def _fused_gates(row_tiles, col_tiles, e, fp, n_real, tau_scr, tau_cb, ti,
                 n_bands, use_cb, use_smh):
    """(e'_rows, e'_cols, gates) of the single-bank fused screen (the
    reference's _fused_gates): _strip_gates with one bank and bases 0."""
    return _strip_gates(row_tiles, col_tiles, e, e, fp, fp, 0, 0, n_real,
                        tau_scr, tau_cb, ti, n_bands, use_cb, use_smh)


def _screen_hits_fused_strips_plain(regs_rows, regs_cols, r_tiles, c_tiles,
                                    e_rows, e_cols, fp_rows, fp_cols,
                                    row_base, col_base, n_real, tau_scr,
                                    tau_cb, p, values, ti, n_bands, use_cb,
                                    use_smh):
    """Plain PyTorch version of K1 over a row strip and a column strip (the
    reference's screen_hits_fused_strips: _screen_fused_call behind the
    strip gates): (int8 hits (T, ti, ti), int32 counts (T,))."""
    values, weights, tail, want_z = telescope(p, values)
    if len(values) < 2:
        raise ValueError("the fused screen needs >= 2 present values")
    m_f = np.float32(1 << p)
    two_m = float(np.float32(2.0) * m_f)
    two_m2 = float(np.float32(2.0) * m_f * m_f)
    e_r, e_c, g = _strip_gates(r_tiles, c_tiles, e_rows, e_cols, fp_rows,
                               fp_cols, row_base, col_base, n_real, tau_scr,
                               tau_cb, ti, n_bands, use_cb, use_smh)
    hits = torch.empty((len(r_tiles), ti, ti), dtype=torch.int8,
                       device=regs_rows.device)
    for t, (r, c) in enumerate(zip(r_tiles.tolist(), c_tiles.tolist())):
        s, z = _cdf_sum(regs_rows[r * ti:(r + 1) * ti],
                        regs_cols[c * ti:(c + 1) * ti], values[:-1], weights,
                        want_z)
        s = s + float(tail)
        e_sum = e_r[t][:, None] + e_c[t][None, :]
        if want_z:
            h = (3.0 * s - z) * e_sum >= two_m2 - two_m * z
        else:
            h = 3.0 * s * e_sum >= two_m2
        hits[t] = (h & g[t]).to(torch.int8)
    return hits, hits.sum((1, 2), dtype=torch.int32)


def _screen_hits_fused_plain(regs, row_tiles, col_tiles, e, fp, n_real,
                             tau_scr, tau_cb, p, values, ti, n_bands, use_cb,
                             use_smh):
    """Plain PyTorch version of K1 on one bank (the reference's
    _screen_fused_call + _fused_gates): the strip version with both sides
    the same and bases 0."""
    return _screen_hits_fused_strips_plain(
        regs, regs, row_tiles, col_tiles, e, e, fp, fp, 0, 0, n_real,
        tau_scr, tau_cb, p, values, ti, n_bands, use_cb, use_smh)


K1_STAGE_WORDS = 32  # plane words of a row that one pipeline stage holds
MMA_DEPTH_WORDS = 8  # plane words (256 registers) of one 1-bit mma depth


def plane_words(p):
    """uint32 words of one bit-plane of a row in K1's plane scratch: 2^p/32,
    padded with zero words to one pipeline stage (1024 registers, four
    256-register depths of its 1-bit mma) when p < 10."""
    return max((1 << p) // 32, K1_STAGE_WORDS)


def plane_row_words(p, nbins):
    """uint32 words of one row of K2's plane scratch: its nbins bit-planes
    one after the other, each 2^p/32 words padded with zero words to one
    mma depth (256 registers) when p < 8, and the whole row padded with zero
    words to whole pipeline stages of 32 words. K2 walks the row four mma
    depths a stage; depth d belongs to bin d // (plane words / 8)."""
    w = max((1 << p) // 32, MMA_DEPTH_WORDS)
    return -(-nbins * w // K1_STAGE_WORDS) * K1_STAGE_WORDS


def _check_side(who, regs, e, fp, n_bands, dev, names):
    """The cardinalities and fingerprints of one side's bank."""
    _check(who, e.device == dev and e.dtype == torch.float32
           and e.shape == (regs.shape[0],) and e.is_contiguous(),
           f"{names[0]} must be contiguous float32 (N_pad,)")
    _check(who, fp.device == dev and fp.dtype == torch.int32
           and fp.shape == (regs.shape[0], n_bands) and fp.is_contiguous(),
           f"{names[1]} must be contiguous int32 (N_pad, n_bands)")


def _launch_fused(who, regs, regs_cols, row_tiles, col_tiles, e, e_cols, fp,
                  fp_cols, row_base, col_base, n_real, tau_scr, tau_cb, p,
                  values, ti, n_bands, use_cb, use_smh, names):
    """Checks the arguments of K1 and launches csc_screen_fused on the
    current stream: (hits, counts). names: the row side's (bank, e, fp)
    names in the messages. A column bank that is the row bank (the same
    tensor object) is packed once: the column plane scratch is then the row
    scratch, and the kernel packs a second bank only when the two scratch
    pointers differ."""
    dev = regs.device
    values, weights, tail, want_z = telescope(p, values)
    r = 1 << p
    same = regs_cols is regs
    _check(who, len(values) >= 2, "needs >= 2 present values")
    _check(who, 0 <= values[0] and values[-1] <= 255, "values outside uint8")
    _check_bank(who, regs, dev, r, ti, names[0])
    if not same:
        _check_bank(who, regs_cols, dev, r, ti, "regs_cols")
    n_tiles = _check_tiles(who, row_tiles, col_tiles, dev)
    _check_side(who, regs, e, fp, n_bands, dev, names[1:])
    _check_side(who, regs_cols, e_cols, fp_cols, n_bands, dev,
                ("e_cols", "fp_cols"))
    _check(who, dev.type == "cuda", f"unsupported device {dev}")

    nbins = len(weights)
    thr, w = _device_telescope(dev, p, values)
    wp = plane_words(p)
    planes = torch.empty((regs.shape[0], nbins, wp), dtype=torch.int32,
                         device=dev)
    planes_c = planes if same else torch.empty(
        (regs_cols.shape[0], nbins, wp), dtype=torch.int32, device=dev)
    hits = torch.empty((n_tiles, ti, ti), dtype=torch.int8, device=dev)
    counts = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    m_f = np.float32(r)
    one_tau = np.float32(1.0) + np.float32(tau_scr)
    _launch("screen_fused", dev,
            regs.data_ptr(), regs.shape[0],
            regs_cols.data_ptr(),
            regs_cols.shape[0], r, thr.data_ptr(), w.data_ptr(), nbins,
            float(tail), int(want_z), float(np.float32(2.0) * m_f),
            float(np.float32(2.0) * m_f * m_f), planes.data_ptr(),
            planes_c.data_ptr(), wp, row_tiles.data_ptr(),
            col_tiles.data_ptr(), n_tiles, ti, e.data_ptr(),
            e_cols.data_ptr(), float(one_tau), fp.data_ptr(),
            fp_cols.data_ptr(), n_bands, int(n_real), int(row_base),
            int(col_base), float(np.float32(tau_cb)), int(use_cb),
            int(use_smh), hits.data_ptr(), counts.data_ptr())
    return hits, counts


def screen_hits_fused(regs, row_tiles, col_tiles, e, fp, n_real, tau_scr,
                      tau_cb, p, values, ti, n_bands, use_cb, use_smh):
    """Fused screen over a (row, col) tile list: (int8 hits (T, ti, ti),
    int32 counts (T,)).

    CPU tensors run _screen_hits_fused_plain. CUDA tensors launch the
    hand-written kernel (csrc/screen_fused.cu: gates first, blocks with no
    live pair skipped, CDF counts as 1-bit tensor-core mma over bit-planes
    of plane_words(p) words) on the current stream or raise; there is no
    fallback. Needs >= 2 present values. It is the strip call
    (screen_hits_fused_strips) with both sides the same and bases 0.

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
    out = _launch_fused("screen_hits_fused", regs, regs, row_tiles,
                        col_tiles, e, e, fp, fp, 0, 0, n_real, tau_scr,
                        tau_cb, p, values, ti, n_bands, use_cb, use_smh,
                        ("regs", "e", "fp"))
    screen_hits_fused.launches += 1
    return out


screen_hits_fused.launches = 0


def screen_hits_fused_strips(regs_rows, regs_cols, r_tiles, c_tiles, e_rows,
                             e_cols, fp_rows, fp_cols, row_base, col_base,
                             n_real, tau_scr, tau_cb, p, values, ti, n_bands,
                             use_cb, use_smh):
    """Fused screen over a row strip and a column strip (the ring engine's
    screen step): (int8 hits (T, ti, ti), int32 counts (T,)).

    r_tiles / c_tiles are local tile indices inside each strip; they index
    regs_rows, e_rows, fp_rows and regs_cols, e_cols, fp_cols. The triangle
    and n_real gates use the global ids row_base + local and col_base +
    local. CPU tensors run _screen_hits_fused_strips_plain; CUDA tensors
    launch K1 (csrc/screen_fused.cu) or raise, with no fallback. Passing
    the row strip's tensors as the column strip's packs its planes once.
    """
    if regs_rows.device.type == "cpu":
        return _screen_hits_fused_strips_plain(
            regs_rows, regs_cols, r_tiles, c_tiles, e_rows, e_cols, fp_rows,
            fp_cols, row_base, col_base, n_real, tau_scr, tau_cb, p, values,
            ti, n_bands, use_cb, use_smh)
    out = _launch_fused("screen_hits_fused_strips", regs_rows, regs_cols,
                        r_tiles, c_tiles, e_rows, e_cols, fp_rows, fp_cols,
                        row_base, col_base, n_real, tau_scr, tau_cb, p,
                        values, ti, n_bands, use_cb, use_smh,
                        ("regs_rows", "e_rows", "fp_rows"))
    screen_hits_fused_strips.launches += 1
    return out


screen_hits_fused_strips.launches = 0
