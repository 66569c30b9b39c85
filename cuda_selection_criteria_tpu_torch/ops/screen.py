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
from two banks, the ring engine's screen), screen_s_z (K2, the raw S
and Z; csrc/weighted_cdf_sum.cu), gate_counts (the gate prune;
csrc/gate_counts.cu), bank_values (present values; csrc/
value_presence.cu) and row_hist (the plan's row histograms and present
values in one pass; csrc/row_hist.cu) run their hand-written CUDA kernels
on CUDA tensors and their plain PyTorch versions on CPU tensors; each
plain version is also its kernel's reference on the card.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build


def _bank_values_plain(flat, chunk):
    """Plain PyTorch version of the presence kernel: one bincount a chunk
    of `chunk` bytes (each cast to int32 on its own, so no cast of the
    whole bank is ever held), then the non-zero bins."""
    counts = torch.zeros(256, dtype=torch.int64, device=flat.device)
    for c0 in range(0, flat.numel(), chunk):
        counts += torch.bincount(flat[c0:c0 + chunk].to(torch.int32),
                                 minlength=256)
    return tuple(torch.nonzero(counts).view(-1).tolist())


def mask_values(mask):
    """Sorted tuple of the values of a 256-bit presence mask: 8 words
    (numpy, any 32-bit integer type), bit b of word w standing for value
    32w + b - the presence kernel's output."""
    words = np.asarray(mask).astype("<u4")
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return tuple(int(v) for v in np.nonzero(bits)[0])


def bank_values(regs, chunk=1 << 24):
    """Sorted tuple of the distinct register values present in a uint8
    bank (numpy array, or tensor - the screened engine scans its device
    copy). One CDF bin per PRESENT value: an absent bin folds into its
    predecessor's weight exactly.

    numpy arrays and CPU tensors run _bank_values_plain (chunk bytes a
    bincount). A CUDA tensor, contiguous, launches the hand-written
    presence kernel (csrc/value_presence.cu: one pass over the bytes into
    a 256-bit mask) on the current stream and reads the mask back in one
    32-byte copy, or raises; there is no fallback. Callers pass the real
    rows only (a zero padding row would add the value 0)."""
    flat = torch.as_tensor(regs)
    who = "bank_values"
    _check(who, flat.dtype == torch.uint8,
           f"uint8 registers expected, got {flat.dtype}")
    dev = flat.device
    if dev.type == "cpu":
        return _bank_values_plain(flat.reshape(-1), chunk)
    _check(who, flat.is_contiguous(), "a contiguous bank expected")
    _check(who, dev.type == "cuda", f"unsupported device {dev}")
    mask = torch.zeros(8, dtype=torch.int32, device=dev)
    if flat.numel():
        _launch("value_presence", dev, flat.data_ptr(), flat.numel(),
                mask.data_ptr())
        bank_values.launches += 1
    return mask_values(mask.cpu().numpy())


bank_values.launches = 0


def _row_hist_plain(regs, chunk_rows):
    """Plain PyTorch version of the row-histogram kernel (the
    counterpart of models/bank._row_hists_numpy): one torch.bincount of
    row * 64 + reg a chunk of `chunk_rows` rows, each chunk cast to int64
    on its own. (int32 (N, 64) histograms, present values)."""
    n = regs.shape[0]
    hist = torch.empty((n, 64), dtype=torch.int32, device=regs.device)
    for c0 in range(0, n, chunk_rows):
        sub = regs[c0:c0 + chunk_rows].to(torch.int64)
        if sub.numel() and int(sub.max()) >= 64:
            raise ValueError("row_hist: a register value >= 64")
        sub += torch.arange(sub.shape[0], device=regs.device)[:, None] * 64
        hist[c0:c0 + chunk_rows] = torch.bincount(
            sub.view(-1), minlength=sub.shape[0] * 64).view(-1, 64)
    present = torch.nonzero((hist > 0).any(0)).view(-1).tolist()
    return hist, tuple(present)


def row_hist(regs, chunk_rows=2048):
    """Register histograms of every row of a uint8 (N, R) bank tensor and
    the bank's present values, in one pass: (int32 (N, 64) tensor on the
    bank's device, hist[i, v] = #{r : regs[i, r] == v}; sorted tuple of the
    distinct values, as bank_values gives them). The histograms feed the
    f64 MLE of the cardinalities (models/bank.cards_from_hists), the
    values the screen's telescope. Raises ValueError for a register value >= 64, as
    native.row_hist does (such a value has no bin).

    CPU tensors run _row_hist_plain (chunk_rows rows a bincount). A CUDA
    tensor, contiguous, with rows of fewer than 2^31 registers, launches
    the hand-written kernel (csrc/row_hist.cu: one warp a row, each byte
    one shared reduction on the lane's own 32-bit counter of its value,
    the 256-bit present-value mask of the same bytes) on the
    current stream and reads the mask back in one 32-byte copy, or raises;
    there is no fallback."""
    who = "row_hist"
    _check(who, regs.dtype == torch.uint8 and regs.dim() == 2,
           f"a 2-D uint8 bank expected, got {regs.dim()}-D {regs.dtype}")
    dev = regs.device
    if dev.type == "cpu":
        return _row_hist_plain(regs, chunk_rows)
    _check(who, regs.is_contiguous(), "a contiguous bank expected")
    _check(who, dev.type == "cuda", f"unsupported device {dev}")
    n, r = regs.shape
    _check(who, r < 1 << 31, "rows of 2^31 registers or more")
    hist = torch.empty((n, 64), dtype=torch.int32, device=dev)
    mask = torch.zeros(8, dtype=torch.int32, device=dev)
    if n and r:
        _launch("row_hist", dev, regs.data_ptr(), n, r, hist.data_ptr(),
                mask.data_ptr())
        row_hist.launches += 1
    else:
        hist.zero_()
    words = mask.cpu().numpy()
    if words[2:].any():  # the error word: a byte of 64 or more
        raise ValueError("row_hist: a register value >= 64")
    return hist, mask_values(words)


row_hist.launches = 0


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


def _check_bank(who, regs, dev, r, rows_per_tile, name, row_map=None):
    """A bank whose sorted rows the tiles index: its own rows, or those of
    row_map (int32, sorted row -> bank row) when one is given. Returns the
    number of sorted rows."""
    _check(who, regs.device == dev and regs.dtype == torch.uint8
           and regs.dim() == 2 and regs.is_contiguous()
           and regs.shape[1] == r,
           f"{name} must be contiguous uint8 (N_pad, 2^p) on {dev}")
    _check(who, r % 32 == 0 and regs.data_ptr() % 16 == 0,
           f"needs p >= 5 and a 16-byte aligned {name}")
    n_sorted = regs.shape[0]
    if row_map is not None:
        _check(who, row_map.device == dev and row_map.dtype == torch.int32
               and row_map.dim() == 1 and row_map.is_contiguous(),
               f"the row map of {name} must be contiguous int32 (N_pad,) on "
               f"{dev}")
        n_sorted = row_map.shape[0]
    _check(who, rows_per_tile % 64 == 0 and n_sorted % rows_per_tile == 0,
           f"the tile edge of {name} must be a multiple of 64 dividing its "
           "rows")
    return n_sorted


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


def _sorted_block(regs, row_map, t, ti):
    """Sorted rows t * ti .. t * ti + ti - 1 of a bank: a slice, or a
    gather through its row map (sorted row -> bank row)."""
    if row_map is None:
        return regs[t * ti:(t + 1) * ti]
    return regs[row_map[t * ti:(t + 1) * ti].to(torch.int64)]


def _screen_hits_fused_strips_plain(regs_rows, regs_cols, r_tiles, c_tiles,
                                    e_rows, e_cols, fp_rows, fp_cols,
                                    row_base, col_base, n_real, tau_scr,
                                    tau_cb, p, values, ti, n_bands, use_cb,
                                    use_smh, row_map=None, col_map=None):
    """Plain PyTorch version of K1 over a row strip and a column strip (the
    reference's screen_hits_fused_strips: _screen_fused_call behind the
    strip gates): (int8 hits (T, ti, ti), int32 counts (T,)). row_map /
    col_map: each side's rows through its map, as the kernel reads them."""
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
        s, z = _cdf_sum(_sorted_block(regs_rows, row_map, r, ti),
                        _sorted_block(regs_cols, col_map, c, ti), values[:-1],
                        weights, want_z)
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
                             use_smh, row_map=None):
    """Plain PyTorch version of K1 on one bank (the reference's
    _screen_fused_call + _fused_gates): the strip version with both sides
    the same and bases 0."""
    return _screen_hits_fused_strips_plain(
        regs, regs, row_tiles, col_tiles, e, e, fp, fp, 0, 0, n_real,
        tau_scr, tau_cb, p, values, ti, n_bands, use_cb, use_smh, row_map,
        row_map)


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


class LaunchTiles(NamedTuple):
    """One K1 launch's tiles and the plane scratch they read, as int32
    tensors on the launch's device (launch_tiles builds it from the host's
    tile lists). The distinct row blocks (in units of ti bank rows) that
    the tiles read on each side, ascending, and each tile's slot in its
    side's list: the pack stage writes block row_blocks[s] into scratch
    rows s * ti .. s * ti + ti - 1, and K1 reads a tile's planes at its
    slots; the gates, e, fp and the hits keep the tile ids. col_blocks is
    row_blocks (one tensor) when one list serves both sides of one bank."""
    row_tiles: torch.Tensor   # (T,)
    col_tiles: torch.Tensor   # (T,)
    row_blocks: torch.Tensor  # (Br,)
    col_blocks: torch.Tensor  # (Bc,)
    row_slot: torch.Tensor    # (T,): row_blocks[row_slot[t]] == row_tiles[t]
    col_slot: torch.Tensor    # (T,): col_blocks[col_slot[t]] == col_tiles[t]


def block_slots(row_tiles, col_tiles, shared):
    """(row_blocks, col_blocks, row_slot, col_slot), numpy int32, of a tile
    list given as numpy: np.unique with its inverse, on the host, so a
    launch needs no device sort and no device-to-host read. shared: one
    list for both sides (one bank on both); col_blocks is then
    row_blocks."""
    r = np.asarray(row_tiles).reshape(-1)
    c = np.asarray(col_tiles).reshape(-1)
    if shared:
        blocks, inv = np.unique(np.concatenate([r, c]), return_inverse=True)
        blocks = blocks.astype(np.int32)
        inv = inv.reshape(-1).astype(np.int32)
        out = blocks, blocks, inv[:len(r)], inv[len(r):]
    else:
        rb, rs = np.unique(r, return_inverse=True)
        cb, cs = np.unique(c, return_inverse=True)
        out = (rb.astype(np.int32), cb.astype(np.int32),
               rs.reshape(-1).astype(np.int32),
               cs.reshape(-1).astype(np.int32))
    if not (np.array_equal(out[0][out[2]], r)
            and np.array_equal(out[1][out[3]], c)):
        raise ValueError("block_slots: a slot does not name its tile's block")
    return out


def launch_tiles(row_tiles, col_tiles, shared, device):
    """The LaunchTiles of a host tile list (numpy or CPU tensors) on
    `device`, all in one host-to-device copy: the screen's callers hold
    their tiles on the host, and K1 takes the launch's blocks from them
    (block_slots). shared as block_slots takes it."""
    rb, cb, rs, cs = block_slots(row_tiles, col_tiles, shared)
    parts = [np.asarray(row_tiles, np.int32).reshape(-1),
             np.asarray(col_tiles, np.int32).reshape(-1), rb, rs, cs]
    if not shared:
        parts.append(cb)
    flat = torch.from_numpy(np.concatenate(parts)).to(device)
    rt, ct, rb, rs, cs, *rest = torch.split(flat, [len(x) for x in parts])
    return LaunchTiles(rt, ct, rb, rest[0] if rest else rb, rs, cs)


def _check_launch_tiles(who, tiles, n_rows, n_cols, ti, dev, same):
    """A LaunchTiles whose tile ids and block lists fit their banks of
    n_rows and n_cols sorted rows; one shared list needs one bank on both
    sides. Returns the tile count."""
    n_tiles = _check_tiles(who, tiles.row_tiles, tiles.col_tiles, dev)
    for name, x, most in (
            ("row_blocks", tiles.row_blocks, n_rows // ti),
            ("col_blocks", tiles.col_blocks, n_cols // ti)):
        _check(who, x.device == dev and x.dtype == torch.int32
               and x.dim() == 1 and 1 <= x.shape[0] <= most
               and x.is_contiguous(),
               f"tiles.{name} must be contiguous int32 (1..bank rows / ti,)"
               f" on {dev}")
        _check(who, x.shape[0] * ti < 2**31,
               "a side's scratch rows must fit int32 (K1's plane offsets)")
    for name, x in (("row_slot", tiles.row_slot),
                    ("col_slot", tiles.col_slot)):
        _check(who, x.device == dev and x.dtype == torch.int32
               and x.shape == (n_tiles,) and x.is_contiguous(),
               f"tiles.{name} must be contiguous int32 (T,) on {dev}")
    _check(who, same or tiles.col_blocks is not tiles.row_blocks,
           "a shared block list needs one bank on both sides")
    return n_tiles


def _check_side(who, n_sorted, e, fp, n_bands, dev, names):
    """The cardinalities and fingerprints of one side's n_sorted rows."""
    _check(who, e.device == dev and e.dtype == torch.float32
           and e.shape == (n_sorted,) and e.is_contiguous(),
           f"{names[0]} must be contiguous float32 (N_pad,)")
    _check(who, fp.device == dev and fp.dtype == torch.int32
           and fp.shape == (n_sorted, n_bands) and fp.is_contiguous(),
           f"{names[1]} must be contiguous int32 (N_pad, n_bands)")


def _launch_fused(who, regs, regs_cols, tiles, e, e_cols, fp, fp_cols,
                  row_base, col_base, n_real, tau_scr, tau_cb, p, values, ti,
                  n_bands, use_cb, use_smh, names, row_map=None,
                  col_map=None):
    """Checks the arguments of K1 and launches csc_screen_fused on the
    current stream: (hits, counts). names: the row side's (bank, e, fp)
    names in the messages. The plane scratch holds the launch's row blocks
    only (tiles, a LaunchTiles). A column bank that is the row bank (the
    same tensor object, through the same map) with one shared block list
    is packed once: the column plane scratch is then the row scratch, and
    the kernel packs a second list only when the two scratch pointers
    differ. row_map / col_map: int32 (N_pad,) sorted row -> bank row of
    each side, or None where the bank's rows are the sorted rows; the
    caller vouches that every entry names a row of its bank."""
    dev = regs.device
    values, weights, tail, want_z = telescope(p, values)
    r = 1 << p
    same = regs_cols is regs and col_map is row_map
    _check(who, len(values) >= 2, "needs >= 2 present values")
    _check(who, 0 <= values[0] and values[-1] <= 255, "values outside uint8")
    n_rows = n_cols = _check_bank(who, regs, dev, r, ti, names[0], row_map)
    if not same:
        n_cols = _check_bank(who, regs_cols, dev, r, ti, "regs_cols",
                             col_map)
    n_tiles = _check_launch_tiles(who, tiles, n_rows, n_cols, ti, dev, same)
    _check_side(who, n_rows, e, fp, n_bands, dev, names[1:])
    _check_side(who, n_cols, e_cols, fp_cols, n_bands, dev,
                ("e_cols", "fp_cols"))
    _check(who, dev.type == "cuda", f"unsupported device {dev}")

    nbins = len(weights)
    thr, w = _device_telescope(dev, p, values)
    wp = plane_words(p)
    n_rb = tiles.row_blocks.shape[0]
    n_cb = tiles.col_blocks.shape[0]
    planes = torch.empty((n_rb * ti, nbins, wp), dtype=torch.int32,
                         device=dev)
    planes_c = (planes if same and tiles.col_blocks is tiles.row_blocks
                else torch.empty((n_cb * ti, nbins, wp), dtype=torch.int32,
                                 device=dev))
    hits = torch.empty((n_tiles, ti, ti), dtype=torch.int8, device=dev)
    counts = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    m_f = np.float32(r)
    one_tau = np.float32(1.0) + np.float32(tau_scr)
    _launch("screen_fused", dev,
            regs.data_ptr(), regs_cols.data_ptr(),
            None if row_map is None else row_map.data_ptr(),
            None if col_map is None else col_map.data_ptr(), r,
            thr.data_ptr(),
            w.data_ptr(), nbins, float(tail), int(want_z),
            float(np.float32(2.0) * m_f), float(np.float32(2.0) * m_f * m_f),
            planes.data_ptr(), planes_c.data_ptr(), wp,
            tiles.row_blocks.data_ptr(), n_rb, tiles.col_blocks.data_ptr(),
            n_cb, tiles.row_tiles.data_ptr(), tiles.col_tiles.data_ptr(),
            tiles.row_slot.data_ptr(), tiles.col_slot.data_ptr(), n_tiles,
            ti, e.data_ptr(), e_cols.data_ptr(), float(one_tau),
            fp.data_ptr(), fp_cols.data_ptr(), n_bands, int(n_real),
            int(row_base), int(col_base), float(np.float32(tau_cb)),
            int(use_cb), int(use_smh), hits.data_ptr(), counts.data_ptr())
    return hits, counts


def screen_hits_fused(regs, tiles, e, fp, n_real, tau_scr, tau_cb, p, values,
                      ti, n_bands, use_cb, use_smh, row_map=None):
    """Fused screen over a (row, col) tile list: (int8 hits (T, ti, ti),
    int32 counts (T,)).

    CPU tensors run _screen_hits_fused_plain. CUDA tensors launch the
    hand-written kernel (csrc/screen_fused.cu: gates first, blocks with no
    live pair skipped, CDF counts as 1-bit tensor-core mma over bit-planes
    of plane_words(p) words, packed for the launch's blocks only) on the
    current stream or raise; there is no fallback. Needs >= 2 present
    values. It is the strip call (screen_hits_fused_strips) with both
    sides the same and bases 0.

    Args:
      regs: uint8 (N_pad, 2^p) sorted, padded register bank; with row_map,
        the bank in any row order (the screened plan's: its own order and
        one zero row).
      tiles: the launch's LaunchTiles (launch_tiles, shared=True): int32
        (T,) row / col block indices in units of ti sorted rows, with the
        blocks they read and their slots.
      e: float32 (N_pad,) truncated cardinalities (0 on padded rows).
      fp: int32 (N_pad, n_bands) LSH band fingerprints (read if use_smh).
      n_real: number of real (unpadded) rows.
      tau_scr, tau_cb: f32 screen and CB thresholds.
      values: sorted present register values (screen truncation applied).
      row_map: optional int32 (N_pad,) bank row of each sorted row; the
        pack stage (and the plain version) read the rows through it.
    """
    if regs.device.type == "cpu":
        return _screen_hits_fused_plain(regs, tiles.row_tiles,
                                        tiles.col_tiles, e, fp, n_real,
                                        tau_scr, tau_cb, p, values, ti,
                                        n_bands, use_cb, use_smh, row_map)
    out = _launch_fused(
        "screen_hits_fused", regs, regs, tiles, e, e, fp, fp, 0, 0, n_real,
        tau_scr, tau_cb, p, values, ti, n_bands, use_cb, use_smh,
        ("regs", "e", "fp"), row_map, row_map)
    screen_hits_fused.launches += 1
    return out


screen_hits_fused.launches = 0


def screen_hits_fused_strips(regs_rows, regs_cols, tiles, e_rows, e_cols,
                             fp_rows, fp_cols, row_base, col_base, n_real,
                             tau_scr, tau_cb, p, values, ti, n_bands, use_cb,
                             use_smh, row_map=None, col_map=None):
    """Fused screen over a row strip and a column strip (the ring engine's
    screen step): (int8 hits (T, ti, ti), int32 counts (T,)).

    tiles (a LaunchTiles) holds local tile indices inside each strip; they
    index regs_rows, e_rows, fp_rows and regs_cols, e_cols, fp_cols, and
    its block lists are over each side's local blocks (launch_tiles with
    shared=False; shared=True only when the two strips are one tensor).
    The triangle and n_real gates use the global ids row_base + local and
    col_base + local. CPU tensors run _screen_hits_fused_strips_plain; CUDA
    tensors launch K1 (csrc/screen_fused.cu) or raise, with no fallback.
    Passing the row strip's tensors (and map) as the column strip's packs
    its planes once. row_map / col_map: optional int32 bank row of each
    local sorted row of a side, read as screen_hits_fused reads its map.
    """
    if regs_rows.device.type == "cpu":
        return _screen_hits_fused_strips_plain(
            regs_rows, regs_cols, tiles.row_tiles, tiles.col_tiles, e_rows,
            e_cols, fp_rows, fp_cols, row_base, col_base, n_real, tau_scr,
            tau_cb, p, values, ti, n_bands, use_cb, use_smh, row_map,
            col_map)
    out = _launch_fused(
        "screen_hits_fused_strips", regs_rows, regs_cols, tiles, e_rows,
        e_cols, fp_rows, fp_cols, row_base, col_base, n_real, tau_scr,
        tau_cb, p, values, ti, n_bands, use_cb, use_smh,
        ("regs_rows", "e_rows", "fp_rows"), row_map, col_map)
    screen_hits_fused_strips.launches += 1
    return out


screen_hits_fused_strips.launches = 0
