"""Screened all-pairs selection engine (single device).

Port of cuda_selection_criteria_tpu/parallel/screened.py. Three-stage
cascade, mirroring the reference's prune-then-confirm design
(src/selection.cpp:270-291):

  1. SCHEDULE (host): sort by cardinality, tile the i<j triangle, drop
     tiles the block-level cardinality bound kills (parallel.scheduler);
     then drop tiles in which no pair passes the cheap gates
     (_gate_counts: CB + LSH fingerprints + triangle).
  2. SCREEN (device): the fused kernel K1 (ops/screen.screen_hits_fused)
     computes per-pair harmonic sums / zero counts and keeps the pairs the
     certified MLE lower bound t_lb = 2m(m-Z)/(3S-Z) cannot exclude. A
     superset of the exact cascade by theorem (DESIGN.md "Screen
     certificate").
  3. CONFIRM (host, exact): the device computes union histograms with a
     certain-reject flag (make_device_hist_fn) and the host f64 oracle
     (utils/hostref.PairOracle) decides every candidate, so emitted pairs
     and Jaccard values are identical to the reference.
"""

import time

import numpy as np
import torch

from ..ops import criteria, screen
from ..ops.estimators import hll_histogram
from ..utils.device import resolve
from ..utils.hostref import PairOracle
from . import scheduler

# Numeric slack on the certified screen threshold: t_lb <= t_mle is a
# theorem, so the margin covers only f32 rounding (~1e-5 budget).
SCREEN_DELTA_DEFAULT = 1e-3


def screen_tau(tau, delta=SCREEN_DELTA_DEFAULT):
    """Conservative screen threshold: t_lb <= e_sum/(1+screen_tau(tau))
    whenever t_mle <= e_sum/(1+tau), given t_lb <= (1+delta)*t_mle."""
    return (1.0 + float(tau)) / (1.0 + float(delta)) - 1.0


def band_fingerprints_np(aux, n_rows, n_bands):
    """int32 (N, n_bands) FNV-mix fingerprints of the LSH bands, host
    numpy (uint64 stays off the device). Band equality implies
    fingerprint equality, so screening on fingerprints is a superset of
    the exact smh_a gate."""
    aux = np.asarray(aux, np.uint64)
    lo = (aux & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (aux >> np.uint64(32)).astype(np.uint32)
    limbs = np.stack([lo, hi], -1).reshape(aux.shape[0], n_bands,
                                           n_rows * 2)
    fp = np.full(limbs.shape[:2], 2166136261, np.uint32)
    mult = np.uint32(16777619)
    with np.errstate(over="ignore"):
        for k in range(n_rows * 2):
            fp = (fp ^ limbs[..., k]) * mult
    return fp.astype(np.int32)


def reject_delta_for(p, screen_delta):
    """Certain-reject margin for a primary precision p: the certified
    bound holds at every precision, so delta is the f32 slack alone."""
    return float(screen_delta)


def auto_tile(n):
    """Schedule tile edge: 1024 once the bank spans several tiles, else
    512. This is the measured TPU v5e rule, kept so tile schedules stay
    bit-equal to the reference's; re-tuning for Hopper is later work."""
    return 1024 if n >= 4096 else 512


def auto_chunk(ti):
    """Tiles per screen launch (the reference's v5e rule, kept as is)."""
    return 64 if ti >= 1024 else 132


def _gate_counts(e, fp, r_tiles, c_tiles, n_real, tau_cb, n_bands, ti,
                 use_cb, use_smh):
    """Per-tile count of pairs passing the cheap gates (CB + LSH
    fingerprints + triangle): tiles with none never reach the kernel,
    like the reference's `continue` past gate-failing pairs
    (src/selection.cpp:282-286)."""
    ii, jj = screen.tile_ids(r_tiles, c_tiles, ti)
    e_a = e[ii]
    e_b = e[jj]
    gate = (ii[:, :, None] < jj[:, None, :]) & (jj[:, None, :] < n_real)
    gate &= e_b[:, None, :] > 0
    if use_cb:
        gate &= e_a[:, :, None] >= float(tau_cb) * e_b[:, None, :]
    if use_smh:
        gate &= screen.band_hit(fp, ii, jj, n_bands)
    return gate.sum((1, 2), dtype=torch.int32)


def _screen_post(s, z, e, fp, r_tiles, c_tiles, n_real, tau_scr, tau_cb, p,
                 n_bands, ti, use_cb, use_smh):
    """Gates + certified-MLE-bound screen over (S, Z) of a chunk of tiles,
    division-free:

      t_lb <= (e1+e2)/(1+tau_scr)
        <=>  (3S - Z)*(e1+e2) >= 2m(m-Z)*(1+tau_scr)

    (3S - Z >= 2Z >= 0, so the cross-multiplication never flips)."""
    m = float(np.float32(1 << p))
    one_tau = float(np.float32(1.0) + np.float32(tau_scr))
    ii, jj = screen.tile_ids(r_tiles, c_tiles, ti)
    e_a = e[ii]
    e_b = e[jj]
    e_sum = e_a[:, :, None] + e_b[:, None, :]
    if z is None:  # no zero registers anywhere in the bank
        hits = 3.0 * s * e_sum >= 2.0 * m * m * one_tau
    else:
        hits = (3.0 * s - z) * e_sum >= 2.0 * m * (m - z) * one_tau
    hits &= (ii[:, :, None] < jj[:, None, :]) & (jj[:, None, :] < n_real)
    hits &= e_b[:, None, :] > 0
    if use_cb:
        hits &= e_a[:, :, None] >= float(tau_cb) * e_b[:, None, :]
    if use_smh:
        hits &= screen.band_hit(fp, ii, jj, n_bands)
    return hits


def _screen_chunk(regs, r_tiles, c_tiles, e, fp, n_real, tau_scr, tau_cb,
                  p, values, ti, n_bands, use_cb, use_smh):
    """One chunk of the screen: (hits (T, ti, ti), per-tile counts (T,)).
    The fused kernel needs >= 2 present values; a single-value bank has
    constant S/Z and takes the two-pass form, as in the reference."""
    if len(values) >= 2:
        return screen.screen_hits_fused(
            regs, r_tiles, c_tiles, e, fp, n_real, tau_scr, tau_cb,
            p, values, ti, n_bands, use_cb, use_smh)
    s, z = screen.screen_s_z(regs, r_tiles, c_tiles, p, values, ti=ti, tj=ti)
    hits = _screen_post(s, z, e, fp, r_tiles, c_tiles, n_real, tau_scr,
                        tau_cb, p, n_bands, ti, use_cb, use_smh)
    return hits, hits.sum((1, 2), dtype=torch.int32)


def extract_hit_coords(hits, ts):
    """[(tile_pos, rows, cols)] for the hit tiles `ts` of one chunk:
    torch.nonzero over just those tiles, one device-to-host copy."""
    idx = torch.from_numpy(np.asarray(ts, np.int64)).to(hits.device)
    nz = torch.nonzero(hits.index_select(0, idx)).cpu().numpy()
    # nonzero is row-major, so each tile's coordinates are contiguous
    bounds = np.searchsorted(nz[:, 0], np.arange(len(ts) + 1))
    return [(int(t), nz[lo:hi, 1], nz[lo:hi, 2])
            for t, lo, hi in zip(ts, bounds[:-1], bounds[1:])]


def make_device_hist_fn(d_regs, d_e, p, tau, delta, chunk=8192):
    """Device union-histogram provider with the certain-reject bound, for
    PairOracle: (ii, kk) -> (B, q+2) exact counts; rows the certified bound
    rejects come back as a sentinel (c[q+1] = m -> MLE inf -> dropped).

    d_regs/d_e: the sorted, padded device bank and its f32 sorted
    cardinalities. The callable carries the .dispatch/.fetch halves and
    the .tau that PairOracle checks."""
    q = 64 - p
    m = 1 << p
    # f32 slop: s is a <= q+2-term f32 sum of exact products c_k * 2^-k;
    # e1+e2 rounds once. 1e-4 covers both with two orders to spare.
    coef = float(np.float32((1.0 + delta) * (1.0 + 1e-4)))
    one_tau = np.float32(1.0 + tau)
    out_t = torch.int16 if p <= 14 else torch.int32
    dev = d_regs.device
    w = torch.from_numpy(np.ldexp(np.ones(q + 2, np.float32),
                                  -np.arange(q + 2)).astype(np.float32)
                         ).to(dev)

    def hist_flag(ii, kk):
        merged = torch.maximum(d_regs[ii], d_regs[kk])
        h = hll_histogram(merged, p)  # (B, q+2) exact counts
        s = (h.to(torch.float32) * w[None, :]).sum(-1)
        t_lb = screen.mle_lower_bound(s, h[:, 0].to(torch.float32), p)
        e_sum = d_e[ii] + d_e[kk]
        # certain reject <=> tau < J upper bound from t_lb <= t_mle
        reject = float(one_tau) * t_lb > coef * e_sum
        return h.to(out_t), reject

    def dispatch(ii, kk):
        """Async: returns (pending device (hist, reject) pairs, nb)."""
        it = torch.from_numpy(np.asarray(ii, np.int64)).to(dev)
        kt = torch.from_numpy(np.asarray(kk, np.int64)).to(dev)
        pending = [hist_flag(it[c0:c0 + chunk], kt[c0:c0 + chunk])
                   for c0 in range(0, len(it), chunk)]
        return pending, len(it)

    def fetch(handle):
        pending, nb = handle
        if nb == 0:
            return np.zeros((0, q + 2), np.int32)
        d_all = torch.cat([h for h, _ in pending])
        if one_tau <= 0.0:  # the bound can never reject: plain fetch
            return d_all.cpu().numpy()
        # one flag byte per pair first; full rows only for survivors
        rej = torch.cat([r for _, r in pending]).cpu().numpy()
        out = np.zeros((nb, q + 2), np.int32)
        out[:, q + 1] = m  # sentinel: MLE inf -> jacc NaN -> dropped
        surv = np.nonzero(~rej)[0]
        if surv.size:
            sel = torch.from_numpy(surv).to(dev)
            out[surv] = d_all.index_select(0, sel).cpu().numpy()
        return out

    def fn(ii, kk):
        return fetch(dispatch(ii, kk))

    fn.dispatch = dispatch
    fn.fetch = fetch
    fn.tau = float(tau)
    return fn


class ScreenPlan:
    """Everything the screen cascade needs, prepared once per bank/params:
    the sorted+padded arrays, the device-resident bank, and the
    conservative thresholds."""

    VALID = ("smh_a", "cb", "baseline")

    def __init__(self, bank, params, ti, device=None):
        crit = params.criterion
        if crit not in self.VALID:
            raise ValueError(
                f"screened engine does not support criterion {crit!r}")
        self.device = resolve(device)
        self.bank = bank
        self.params = params
        self.ti = ti
        self.crit = crit
        self.n = bank.n
        self.tau = params.tau_eff
        self.use_cb = crit != "baseline"
        self.use_smh = crit == "smh_a"

        order = bank.sorted_by_cardinality()
        self.order = order
        self.e_s = np.trunc(bank.cards[order])
        self.aux_s = bank.aux[order] if bank.aux is not None else None
        self._regs_s = None

        # Pad the sorted bank to a tile multiple; padded rows have e == 0
        # and are masked out by the n_real / e_b > 0 gates.
        n = self.n
        n_pad = -(-n // ti) * ti
        self.n_pad = n_pad
        e_p = np.zeros(n_pad, np.float32)
        e_p[:n] = self.e_s
        self.d_e = torch.from_numpy(e_p).to(self.device)

        if self.use_smh:
            n_rows_b, self.n_bands = criteria.smh_band_params(
                bank.aux_param, params.tau)
            aux_p = np.zeros((n_pad, self.aux_s.shape[1]), self.aux_s.dtype)
            aux_p[:n] = self.aux_s
            self.d_fp = torch.from_numpy(band_fingerprints_np(
                aux_p, n_rows_b, self.n_bands)).to(self.device)
        else:
            self.n_bands = 1
            self.d_fp = torch.zeros((n_pad, 1), dtype=torch.int32,
                                    device=self.device)

        # One upload of the raw bank, then a device-side gather of the
        # sorted rows into the zero-padded (n_pad, R) bank.
        raw = torch.from_numpy(bank.regs).to(self.device)
        self.d_regs = torch.zeros((n_pad, bank.regs.shape[1]),
                                  dtype=torch.uint8, device=self.device)
        self.d_regs[:n] = raw[torch.from_numpy(order).to(self.device)]
        del raw

        # Truncated telescope: a one-sided (overestimating) harmonic sum
        # with fewer bins (ops/screen.truncate_values).
        max_card = float(self.e_s.max(initial=1.0))
        self.values = screen.truncate_values(
            screen.bank_values(self.d_regs[:n]), max_card, bank.p)
        self.tau_scr = np.float32(screen_tau(self.tau, params.screen_delta))
        # CB margin: the screen divides in f32; relax by 1e-5 relative and
        # let the oracle apply the exact f64 comparison.
        self.tau_cb = np.float32(self.tau * (1.0 - 1e-5))

    @property
    def regs_s(self):
        """Sorted host register copy, gathered on first touch (only the
        host confirm path on a CPU device and tests need it)."""
        if self._regs_s is None:
            self._regs_s = self.bank.regs[self.order]
        return self._regs_s

    def _tiles(self, ids):
        return torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(
            self.device)

    def schedule(self):
        """Block-level schedule: (rows, cols) tile indices the CB bound
        cannot rule out."""
        rows, cols = scheduler.triangle_block_ids(
            self.e_s, self.tau, self.ti, use_cb_skip=self.use_cb)
        return rows.astype(np.int32), cols.astype(np.int32)

    def prune_tiles(self, rows, cols, chunk=256):
        """Cascade stage 1: keep the tiles in which some pair passes the
        cheap gates; one device-to-host copy for the whole stage."""
        if len(rows) <= 1 or not (self.use_cb or self.use_smh):
            return rows, cols
        counts = []
        for c0 in range(0, len(rows), chunk):
            counts.append(_gate_counts(
                self.d_e, self.d_fp, self._tiles(rows[c0:c0 + chunk]),
                self._tiles(cols[c0:c0 + chunk]), self.n, self.tau_cb,
                self.n_bands, self.ti, self.use_cb, self.use_smh))
        live = torch.cat(counts).cpu().numpy() > 0
        return rows[live], cols[live]

    def screen_chunk(self, r_chunk, c_chunk):
        """One fused screen launch over a chunk of tiles:
        (hits (T, ti, ti), per-tile counts (T,))."""
        return _screen_chunk(
            self.d_regs, self._tiles(r_chunk), self._tiles(c_chunk),
            self.d_e, self.d_fp, self.n, self.tau_scr, self.tau_cb,
            self.bank.p, self.values, self.ti, self.n_bands, self.use_cb,
            self.use_smh)

    def screen_tiles(self, rows, cols, chunk=64, wave=64):
        """Cascade stage 2 over a live-tile list: sorted candidate (i, j).

        Launches every chunk of a wave before reading any result, then
        copies ONE array of per-tile hit counts to the host (one .cpu() per
        wave) and extracts coordinates only from tiles that hold hits.
        Full chunks keep one shape; the remainder is padded to a small
        power-of-two bucket with repeats of the last tile (deduped)."""
        n_live = len(rows)
        if n_live == 0:
            return []
        chunk = min(chunk, n_live)
        ti = self.ti
        spans = [(c0, chunk) for c0 in range(0, n_live - chunk + 1, chunk)]
        rem = n_live - len(spans) * chunk
        if rem:
            bucket = min(chunk, max(8, 1 << (rem - 1).bit_length()))
            spans.append((n_live - rem, bucket))

        cand = []
        for w0 in range(0, len(spans), wave):
            pending = []
            for c0, width in spans[w0:w0 + wave]:
                take = min(width, n_live - c0)
                r_chunk = np.pad(rows[c0:c0 + take], (0, width - take),
                                 constant_values=rows[-1])
                c_chunk = np.pad(cols[c0:c0 + take], (0, width - take),
                                 constant_values=cols[-1])
                hits, cnt = self.screen_chunk(r_chunk, c_chunk)
                pending.append((r_chunk, c_chunk, hits, cnt))
            counts = torch.cat([c for _, _, _, c in pending]).cpu().numpy()
            pos = 0
            for r_chunk, c_chunk, hits, _ in pending:
                width = len(r_chunk)
                ts = np.nonzero(counts[pos:pos + width])[0]
                if ts.size:
                    for t, ri, cj in extract_hit_coords(hits, ts):
                        gi = int(r_chunk[t]) * ti + ri
                        gj = int(c_chunk[t]) * ti + cj
                        cand.extend(zip(gi.tolist(), gj.tolist()))
                pos += width
        return sorted(set(cand))

    def device_hist_fn(self, chunk=8192, tau=None):
        """Batched (ii, kk) -> exact union histograms computed on the
        device bank, with the certain-reject flag (make_device_hist_fn).
        tau defaults to this plan's threshold; an oracle run at another
        tau must pass its own."""
        if tau is None:
            tau = float(self.params.tau)
        delta = reject_delta_for(self.bank.p, self.params.screen_delta)
        return make_device_hist_fn(
            self.d_regs, self.d_e, self.bank.p, tau, delta, chunk=chunk)

    def confirm(self, cand):
        """Cascade stage 3: exact host adjudication of the candidates, with
        device union histograms when the bank lives on CUDA. Returns
        [(i, j, jacc)] in sorted-position order."""
        hist_fn = self.device_hist_fn() if self.device.type == "cuda" else None
        oracle = PairOracle(
            self.bank.p, (lambda: self.regs_s), self.e_s, aux=self.aux_s,
            aux_param=self.bank.aux_param, criterion=self.crit,
            tau=self.params.tau, apply_cb=self.use_cb, hist_fn=hist_fn,
        )
        return oracle.confirm_pairs(cand)


def select_pairs_screened(bank, params, ti=None, chunk=None, device=None,
                          stats=None):
    """All-pairs selection via the fused screen + exact confirmation.

    Returns reference-ordered [(name_i, name_j, jacc)]. ti/chunk default
    to auto_tile/auto_chunk. stats: optional dict, filled with the wall
    seconds of each stage (plan, schedule, prune, screen, confirm) and the
    tile and candidate counts; the screen and prune walls end in a
    device-to-host copy, so they include the device work."""
    if bank.n < 2:
        return []
    if ti is None:
        ti = auto_tile(bank.n)
    if chunk is None:
        chunk = auto_chunk(ti)
    st = {} if stats is None else stats
    t0 = time.perf_counter()
    plan = ScreenPlan(bank, params, ti, device)
    t1 = time.perf_counter()
    rows, cols = plan.schedule()
    t2 = time.perf_counter()
    st.update(plan_secs=t1 - t0, schedule_secs=t2 - t1,
              tiles_scheduled=len(rows))
    if not len(rows):
        return []
    rows, cols = plan.prune_tiles(rows, cols, chunk=max(chunk, 256))
    t3 = time.perf_counter()
    cand = plan.screen_tiles(rows, cols, chunk=chunk)
    t4 = time.perf_counter()
    confirmed = plan.confirm(cand)
    t5 = time.perf_counter()
    st.update(prune_secs=t3 - t2, screen_secs=t4 - t3, confirm_secs=t5 - t4,
              tiles_live=len(rows), candidates=len(cand),
              confirmed=len(confirmed))
    names = bank.names
    order = plan.order
    return [(names[order[i]], names[order[j]], jacc)
            for i, j, jacc in confirmed]
