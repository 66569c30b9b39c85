"""Screened all-pairs selection engine, on one device or with each chunk's
tiles split over a device mesh (select_pairs_screened_sharded).

Port of cuda_selection_criteria_tpu/parallel/screened.py. Three-stage
cascade, mirroring the reference's prune-then-confirm design
(src/selection.cpp:270-291):

  1. SCHEDULE (host): sort by cardinality, tile the i<j triangle, drop
     tiles the block-level cardinality bound kills (parallel.scheduler);
     then drop tiles in which no pair passes the cheap gates
     (_strip_gate_counts: CB + LSH fingerprints + triangle; on the card
     the gate-count kernel, ops/screen.gate_counts).
  2. SCREEN (device): the fused kernel K1 (ops/screen.screen_hits_fused)
     computes per-pair harmonic sums / zero counts and keeps the pairs the
     certified MLE lower bound t_lb = 2m(m-Z)/(3S-Z) cannot exclude. A
     superset of the exact cascade by theorem (DESIGN.md "Screen
     certificate"). hll_a / hll_an add the same bound on the aux sketches
     at p_aux (kernel K2, ops/screen.screen_s_z, then the aux-threshold
     compare).
  3. CONFIRM (host, exact): the device computes union histograms with a
     certain-reject flag (make_device_hist_fn) and the host f64 oracle
     (utils/hostref.PairOracle) decides every candidate, so emitted pairs
     and Jaccard values are identical to the reference.
"""

import contextlib
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

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
# Same certificate, same slack, for the small aux sketches (p_aux 5..8):
# the bound holds at every precision.
SCREEN_DELTA_AUX = 1e-3


def screen_tau(tau, delta=SCREEN_DELTA_DEFAULT):
    """Conservative screen threshold: t_lb <= e_sum/(1+screen_tau(tau))
    whenever t_mle <= e_sum/(1+tau), given t_lb <= (1+delta)*t_mle."""
    return (1.0 + float(tau)) / (1.0 + float(delta)) - 1.0


def hll_aux_threshold_coef(criterion, tau, zs, order_n):
    """Coefficient c with: the exact aux gate passes only if
    t_aux <= c * (e1 + e2).

    hll_a (criteria_sketch.hpp:60-64): K+ >= tau with t+ = t/(1+Z*sigma)
    and (1+gamma)*e2 = e1+e2, so pass <=> t <= (1+zs)(e1+e2)/(1+tau).

    hll_an (criteria_sketch.hpp:52-58): J + C >= tau with
    C = min(1, (1+zs)e2/t) * (1+gamma) * s, s = sum_{k<=n} (zs)^k.
      - min != 1 case: pass <=> t <= (e1+e2)(1 + (1+zs)s)/(1+tau);
      - min == 1 case: C <= 2s (gamma <= 1 after the sort), so
        pass => t <= (e1+e2)/(1+tau-2s)  (None = the gate cannot prune
        when 1+tau-2s <= 0).
    The max of the two cases is a valid one-sided bound for the screen.
    """
    tau = float(tau)
    zs = float(zs)
    if criterion == "hll_a":
        return (1.0 + zs) / (1.0 + tau)
    s = criteria.zs_series(zs, order_n)
    c_b = (1.0 + (1.0 + zs) * s) / (1.0 + tau)
    if 1.0 + tau - 2.0 * s <= 0.0:
        return None
    return max(c_b, 1.0 / (1.0 + tau - 2.0 * s))


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


# Tiles per gate-count launch on the card: the kernel holds no mask, so a
# launch is bounded by nothing but its grid, and a 524,288-row triangle
# (131,328 tiles at ti = 1024) takes three.
GATE_LAUNCH_TILES = 65536


class Strip(NamedTuple):
    """One side of a screen: uint8 registers (rows, 2^p), uint8 aux-HLL
    registers or None, f32 cardinalities, int32 fingerprints, and the
    global sorted position of its first row. The single-device engine's
    bank is one strip at base 0; the ring's strips cover the bank."""
    regs: torch.Tensor
    aux: Optional[torch.Tensor]
    e: torch.Tensor
    fp: torch.Tensor
    base: int

    def to(self, device):
        """The strip on `device`: new tensors, or these on their own
        device (never written in place, so sharing is safe)."""
        return Strip(*(None if t is None else t.to(device, non_blocking=True)
                       for t in self[:4]), self.base)


def _strip_gate_counts(e_rows, e_cols, fp_rows, fp_cols, row_base, col_base,
                       r_tiles, c_tiles, n_real, tau_cb, n_bands, ti, use_cb,
                       use_smh):
    """Per-tile count of pairs passing the cheap gates (CB + LSH
    fingerprints + triangle on global ids) over a row strip and a column
    strip: tiles with none never reach the kernel, like the reference's
    `continue` past gate-failing pairs (src/selection.cpp:282-286). One
    bank is (e, e, fp, fp, 0, 0). CUDA tensors launch the gate-count kernel
    (screen.gate_counts), CPU tensors its plain version."""
    return screen.gate_counts(e_rows, e_cols, fp_rows, fp_cols, r_tiles,
                              c_tiles, row_base, col_base, n_real, tau_cb,
                              n_bands, ti, use_cb, use_smh)


def _strip_post(s, z, e_rows, e_cols, fp_rows, fp_cols, row_base, col_base,
                r_tiles, c_tiles, n_real, tau_scr, tau_cb, p, n_bands, ti,
                use_cb, use_smh):
    """Gates + certified-MLE-bound screen over (S, Z) of a chunk of tiles
    of a row strip and a column strip, division-free:

      t_lb <= (e1+e2)/(1+tau_scr)
        <=>  (3S - Z)*(e1+e2) >= 2m(m-Z)*(1+tau_scr)

    (3S - Z >= 2Z >= 0, so the cross-multiplication never flips). bool
    (C, ti, ti)."""
    m = float(np.float32(1 << p))
    one_tau = float(np.float32(1.0) + np.float32(tau_scr))
    rl, cl = screen.tile_ids(r_tiles, c_tiles, ti)
    e_a = e_rows[rl]
    e_b = e_cols[cl]
    e_sum = e_a[:, :, None] + e_b[:, None, :]
    if z is None:  # no zero registers anywhere in the bank
        hits = 3.0 * s * e_sum >= 2.0 * m * m * one_tau
    else:
        hits = (3.0 * s - z) * e_sum >= 2.0 * m * (m - z) * one_tau
    return hits & screen.pair_gates(e_a, e_b, fp_rows, fp_cols, rl, cl,
                                    row_base, col_base, n_real, tau_cb,
                                    n_bands, use_cb, use_smh)


def _strip_aux_pass(s_a, z_a, e_rows, e_cols, r_tiles, c_tiles, coef_aux,
                    p_aux, ti):
    """The hll-aux union gate over (S_a, Z_a) at p_aux: the exact aux gate
    passes only when t_aux <= coef * (e1+e2) (hll_aux_threshold_coef), so
    the certified bound t_lb = 2m_a(m_a - Z_a)/(3S_a - Z_a) is compared
    division-free, in the reference's f32 operation order. bool
    (C, ti, ti)."""
    m_a = float(np.float32(1 << p_aux))
    rl, cl = screen.tile_ids(r_tiles, c_tiles, ti)
    e_sum = e_rows[rl][:, :, None] + e_cols[cl][:, None, :]
    # Absolute slack on top of the multiplicative margin: the exact hll_a
    # gate floors t_hat (a size_t cast), which can admit up to +1 beyond
    # the continuous bound; +(1+delta) covers that for every union size.
    slack = float(np.float32(1.0 + SCREEN_DELTA_AUX))
    thresh = e_sum * float(np.float32(coef_aux)) + slack  # > 0 always
    if z_a is None:
        return 2.0 * m_a * m_a <= 3.0 * s_a * thresh
    return 2.0 * m_a * (m_a - z_a) <= (3.0 * s_a - z_a) * thresh


def _screen_strip_pair(rows, cols, r_tiles, c_tiles, n_real, tau_scr,
                       tau_cb, p, values, ti, n_bands, use_cb, use_smh,
                       aux=None, coef_aux=None):
    """One chunk of the screen of row strip `rows` against column strip
    `cols` (Strips on one device), over local tile ids: (hits (T, ti, ti),
    per-tile counts (T,)). Every engine's screen step.

    The fused kernel K1 needs >= 2 present values: one strip passed as
    both sides at base 0 is the single-bank call (screen_hits_fused),
    anything else its strip variant. A single-value bank has constant S/Z
    and takes the two-pass form (screen_s_z, _strip_post), as in the
    reference. aux = (p_aux, values_aux) adds the hll-aux union gate: K2 at
    p_aux over the strips' aux registers and _strip_aux_pass, ANDed into
    the hits; S_a and Z_a die with this call."""
    if len(values) >= 2:
        if cols is rows and rows.base == 0:
            hits, counts = screen.screen_hits_fused(
                rows.regs, r_tiles, c_tiles, rows.e, rows.fp, n_real,
                tau_scr, tau_cb, p, values, ti, n_bands, use_cb, use_smh)
        else:
            hits, counts = screen.screen_hits_fused_strips(
                rows.regs, cols.regs, r_tiles, c_tiles, rows.e, cols.e,
                rows.fp, cols.fp, rows.base, cols.base, n_real, tau_scr,
                tau_cb, p, values, ti, n_bands, use_cb, use_smh)
    else:
        s, z = screen.screen_s_z(
            rows.regs, r_tiles, c_tiles, p, values, ti=ti, tj=ti,
            regs_cols=None if cols.regs is rows.regs else cols.regs)
        hits = _strip_post(s, z, rows.e, cols.e, rows.fp, cols.fp, rows.base,
                           cols.base, r_tiles, c_tiles, n_real, tau_scr,
                           tau_cb, p, n_bands, ti, use_cb, use_smh)
        counts = None
    if aux is not None:
        s_a, z_a = screen.screen_s_z(
            rows.aux, r_tiles, c_tiles, aux[0], aux[1], ti=ti, tj=ti,
            regs_cols=None if cols.aux is rows.aux else cols.aux)
        hits.masked_fill_(~_strip_aux_pass(s_a, z_a, rows.e, cols.e, r_tiles,
                                           c_tiles, coef_aux, aux[0], ti), 0)
        counts = None
    if counts is None:
        counts = hits.sum((1, 2), dtype=torch.int32)
    return hits, counts


def _screen_chunk(regs, r_tiles, c_tiles, e, fp, n_real, tau_scr, tau_cb,
                  p, values, ti, n_bands, use_cb, use_smh):
    """One chunk of the single-bank screen: (hits (T, ti, ti), per-tile
    counts (T,)), _screen_strip_pair of the bank against itself."""
    side = Strip(regs, None, e, fp, 0)
    return _screen_strip_pair(side, side, r_tiles, c_tiles, n_real, tau_scr,
                              tau_cb, p, values, ti, n_bands, use_cb,
                              use_smh)


def _screen_chunk_hllaux(regs, aux_regs, r_tiles, c_tiles, e, fp, n_real,
                         tau_scr, tau_cb, coef_aux, p, values, p_aux,
                         values_aux, ti):
    """One chunk of the single-bank hll_a / hll_an screen: the primary
    screen (K1 with CB, no LSH bands), then the aux-union gate at p_aux
    (K2 and _strip_aux_pass), ANDed into the hits."""
    side = Strip(regs, aux_regs, e, fp, 0)
    return _screen_strip_pair(side, side, r_tiles, c_tiles, n_real, tau_scr,
                              tau_cb, p, values, ti, 1, True, False,
                              aux=(p_aux, values_aux), coef_aux=coef_aux)


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


class _SweepCheckpoint:
    """Append-only JSONL progress log for long screen sweeps; the file
    format is the reference package's, so a file written by either package
    resumes in the other.

    Line 0: a header binding the file to one exact run (bank size,
    criterion, tau, tile, chunk and a hash of the pruned tile schedule):
    resuming against a different run raises instead of mixing results.
    Each further line: {"span": [c0, width], "cand": [[i, j], ...]} for one
    completed launch span. A torn final line (a crash mid-write) is
    ignored and its span recomputed. fsync every 64 records and at close
    bounds the lost work."""

    def __init__(self, fh, done_spans, done_candidates):
        self._fh = fh
        self.done_spans = done_spans
        self.done_candidates = done_candidates
        self._since_sync = 0

    @classmethod
    def open(cls, path, plan, rows, cols, chunk):
        if path is None:
            return None
        header = {
            "schedule_hash": hashlib.sha1(
                rows.tobytes() + cols.tobytes()).hexdigest()[:16],
            "n": int(plan.n),
            "criterion": plan.crit,
            "tau": float(plan.params.tau),
            "ti": int(plan.ti),
            # spans are a function of the chunk: a resume with another
            # chunk raises instead of recomputing every span while still
            # prepending the old candidates
            "chunk": int(chunk),
        }
        done_spans = set()
        done_cand = []
        if os.path.exists(path) and os.path.getsize(path):
            with open(path) as fh:
                first = fh.readline()
                try:
                    if json.loads(first) != header:
                        raise ValueError(
                            f"checkpoint {path!r} belongs to a different "
                            "run (bank/params/schedule changed)")
                except json.JSONDecodeError as exc:
                    raise ValueError(
                        f"corrupt checkpoint header in {path!r}") from exc
                for line in fh:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break  # torn tail line: recompute that span
                    done_spans.add(tuple(rec["span"]))
                    done_cand.extend(map(tuple, rec["cand"]))
            fh = open(path, "a")
        else:
            fh = open(path, "w")
            fh.write(json.dumps(header) + "\n")
            fh.flush()
        return cls(fh, done_spans, done_cand)

    def record(self, span, cand):
        self._fh.write(json.dumps(
            {"span": list(span), "cand": [list(c) for c in cand]}) + "\n")
        self._since_sync += 1
        if self._since_sync >= 64:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._since_sync = 0

    def close(self):
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()


# Host threads that share each slab's gather in upload_sorted_rows: the
# gather binds, and on the 8-core host of an NVIDIA H100 80GB HBM3 (700 W)
# one thread gathered 3.4 to 4.2 GiB/s, eight 16.3 to 18.0
# (experiments/upload_sweep.py).
UPLOAD_THREADS = min(8, os.cpu_count() or 1)


def upload_sorted_rows(bank_regs, order, lo, rows_out, device=None,
                       slab_bytes=128 << 20, stats=None,
                       threads=UPLOAD_THREADS):
    """Slab-pipelined upload of sorted bank rows [lo, lo + rows_out) to one
    device: a uint8 (rows_out, R) tensor on resolve(device) holding rows
    order[lo:lo + count] of bank_regs, rows past len(order) zero. Port of
    the reference's upload_sorted_rows with pack=None.

    The host gathers a slab of slab_bytes // R sorted rows into one of two
    reused arenas (pinned on CUDA) and copies it into the output with a
    non_blocking copy on the current stream, recording an event after each
    copy; an arena is refilled only once its event has passed (the
    reference's _place_rows token, timed as token_wait_secs). So the
    device holds the output alone, never the raw bank or a gathered copy,
    and the gather of slab k+1 overlaps the copy of slab k. The gather
    binds, so `threads` host threads share each slab (np.take releases the
    interpreter lock). On the CPU the arenas are plain and the copy
    synchronous. Ends in a synchronize.

    stats: optional dict; gets the reference's keys (slabs, gather_secs,
    put_ret_secs, token_wait_secs, and pack_secs 0.0 and pack_bits 0: the
    tunnel's bit-plane packing is not ported), added to what it holds."""
    dev = resolve(device)
    cuda = dev.type == "cuda"
    r = bank_regs.shape[1]
    slab = max(1, slab_bytes // max(r, 1))
    count = max(0, min(len(order) - lo, rows_out))
    out = torch.empty((rows_out, r), dtype=torch.uint8, device=dev)
    out[count:].zero_()
    if count == 0:
        if cuda:
            torch.cuda.synchronize(dev)
        return out
    ph = stats if stats is not None else {}
    ph.setdefault("slabs", 0)
    ph["pack_bits"] = 0
    for key in ("gather_secs", "put_ret_secs", "token_wait_secs",
                "pack_secs"):
        ph.setdefault(key, 0.0)
    # a failed pin raises: a pageable arena would make the copies
    # synchronous and the overlap silent
    arenas = [torch.empty((min(slab, count), r), dtype=torch.uint8,
                          pin_memory=cuda) for _ in range(2)]
    hosts = [a.numpy() for a in arenas]
    events = [None, None]

    def gather(dst, rows, a, b):
        # mode="clip": the indices are valid, and "raise" would gather
        # into a buffer of numpy's own first
        np.take(bank_regs, rows[a:b], axis=0, out=dst[a:b], mode="clip")

    with contextlib.ExitStack() as ctx:
        if cuda:
            ctx.enter_context(torch.cuda.device(dev))
        pool = (ctx.enter_context(ThreadPoolExecutor(threads))
                if threads > 1 else None)
        for idx, k0 in enumerate(range(0, count, slab)):
            tp = time.perf_counter()
            if events[idx % 2] is not None:
                events[idx % 2].synchronize()  # its last copy has finished
            ph["token_wait_secs"] += time.perf_counter() - tp
            rows = order[lo + k0: lo + min(k0 + slab, count)]
            k = len(rows)
            tp = time.perf_counter()
            if pool is None:
                gather(hosts[idx % 2], rows, 0, k)
            else:
                cut = np.linspace(0, k, threads + 1).astype(int)
                list(pool.map(gather, [hosts[idx % 2]] * threads,
                              [rows] * threads, cut[:-1], cut[1:]))
            ph["gather_secs"] += time.perf_counter() - tp
            tp = time.perf_counter()
            out[k0:k0 + k].copy_(arenas[idx % 2][:k], non_blocking=cuda)
            if cuda:
                events[idx % 2] = torch.cuda.Event()
                events[idx % 2].record()
            ph["put_ret_secs"] += time.perf_counter() - tp
            ph["slabs"] += 1
        if cuda:
            torch.cuda.synchronize(dev)
    return out


class ScreenPlan:
    """Everything the screen cascade needs, prepared once per bank/params:
    the sorted+padded arrays, the device-resident bank, and the
    conservative thresholds. upload_secs is the wall of the register
    banks' uploads inside __init__ (upload_sorted_rows, each ending in a
    synchronize; the reference plan's upload_secs), and upload_stats the
    primary bank's upload split: upload_sorted_rows's keys and
    wire_wait_secs, the wall the host stages leave, as the reference
    computes it."""

    VALID = ("smh_a", "smh_only", "cb", "baseline", "hll_a", "hll_an")

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
        self.use_cb = crit not in ("baseline", "smh_only")
        self.use_smh = crit in ("smh_a", "smh_only")

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

        t_up = time.perf_counter()
        self.upload_stats = {}
        self.d_regs = upload_sorted_rows(bank.regs, order, 0, n_pad,
                                         self.device, stats=self.upload_stats)
        self.upload_secs = time.perf_counter() - t_up
        if self.upload_stats:
            self.upload_stats["wire_wait_secs"] = round(
                self.upload_secs - self.upload_stats["gather_secs"]
                - self.upload_stats["pack_secs"]
                - self.upload_stats["put_ret_secs"], 2)

        # Truncated telescope: a one-sided (overestimating) harmonic sum
        # with fewer bins (ops/screen.truncate_values).
        max_card = float(self.e_s.max(initial=1.0))
        self.values = screen.truncate_values(
            screen.bank_values(self.d_regs[:n]), max_card, bank.p)
        self.tau_scr = np.float32(screen_tau(self.tau, params.screen_delta))

        # Device aux-union gate of the hll-aux criteria: the exact gate
        # passes only when t_aux <= coef * (e1+e2), so the aux sketches get
        # the same harmonic-sum screen at p_aux. None when the gate cannot
        # prune at this tau (the plain K1 chunk then runs alone).
        self.coef_aux = self.values_aux = self.d_aux_regs = None
        if crit in ("hll_a", "hll_an"):
            zs = criteria.z_sigma(params.z_score, bank.aux_param)
            coef = hll_aux_threshold_coef(crit, self.tau, zs, params.order_n)
            if coef is not None:
                self.coef_aux = np.float32(coef * (1.0 + SCREEN_DELTA_AUX))
                t_up = time.perf_counter()
                self.d_aux_regs = upload_sorted_rows(bank.aux, order, 0,
                                                     n_pad, self.device)
                self.upload_secs += time.perf_counter() - t_up
                # present values are permutation-invariant: the sorted
                # real rows hold those of the unsorted aux bank
                self.values_aux = screen.truncate_values(
                    screen.bank_values(self.d_aux_regs[:n]),
                    float(np.trunc(bank.cards).max(initial=1.0)),
                    bank.aux_param)
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

    def prune_tiles(self, rows, cols, chunk=256, stats=None):
        """Cascade stage 1: keep the tiles in which some pair passes the
        cheap gates; one device-to-host copy for the whole stage.

        chunk: tiles a gate call on the CPU, where the plain version holds
        (chunk, ti, ti) masks. On the card the kernel holds none, and every
        launch takes up to GATE_LAUNCH_TILES tiles whatever chunk says.

        stats: optional dict, filled with the reference's keys for the
        stage's wall split: gate_chunks, gate_first_dispatch_secs (the
        first chunk's launches), gate_dispatch_secs (every chunk's) and
        gate_fetch_secs (the one count read). CUDA launches are
        asynchronous, so the device's time lands in whichever half waits
        for it: the fetch, or the dispatch once the launches wait on the
        card (they do over a large bank's many chunks). The tiles kept are
        the same with or without stats."""
        if len(rows) <= 1 or not (self.use_cb or self.use_smh):
            return rows, cols
        if self.device.type == "cuda":
            chunk = GATE_LAUNCH_TILES
        counts = []
        t0 = time.perf_counter()
        t_first = None
        for c0 in range(0, len(rows), chunk):
            counts.append(_strip_gate_counts(
                self.d_e, self.d_e, self.d_fp, self.d_fp, 0, 0,
                self._tiles(rows[c0:c0 + chunk]),
                self._tiles(cols[c0:c0 + chunk]), self.n, self.tau_cb,
                self.n_bands, self.ti, self.use_cb, self.use_smh))
            if t_first is None:
                t_first = time.perf_counter() - t0
        t_disp = time.perf_counter() - t0
        live = torch.cat(counts).cpu().numpy() > 0
        if stats is not None:
            stats.update(gate_chunks=len(counts),
                         gate_first_dispatch_secs=t_first,
                         gate_dispatch_secs=t_disp,
                         gate_fetch_secs=time.perf_counter() - t0 - t_disp)
        return rows[live], cols[live]

    def screen_chunk(self, r_chunk, c_chunk):
        """One fused screen launch over a chunk of tiles:
        (hits (T, ti, ti), per-tile counts (T,))."""
        if self.coef_aux is not None:
            return _screen_chunk_hllaux(
                self.d_regs, self.d_aux_regs, self._tiles(r_chunk),
                self._tiles(c_chunk), self.d_e, self.d_fp, self.n,
                self.tau_scr, self.tau_cb, self.coef_aux, self.bank.p,
                self.values, self.bank.aux_param, self.values_aux, self.ti)
        return _screen_chunk(
            self.d_regs, self._tiles(r_chunk), self._tiles(c_chunk),
            self.d_e, self.d_fp, self.n, self.tau_scr, self.tau_cb,
            self.bank.p, self.values, self.ti, self.n_bands, self.use_cb,
            self.use_smh)

    def screen_tiles(self, rows, cols, chunk=64, checkpoint=None, wave=64,
                     screen_fn=None, quantum=1):
        """Cascade stage 2 over a live-tile list: sorted candidate (i, j).

        Launches every chunk of a wave before reading any result, then
        copies ONE array of per-tile hit counts to the host (one .cpu() per
        wave) and extracts coordinates only from tiles that hold hits.
        Full chunks keep one shape; the remainder is padded to a small
        power-of-two bucket with repeats of the last tile (deduped).

        checkpoint: optional progress file (_SweepCheckpoint): each span's
        candidates are appended once its wave is read, and a restarted run
        with the same bank, params and schedule skips the spans done.

        screen_fn: optional (r_chunk, c_chunk) -> (hits, counts) in place of
        screen_chunk; the tile-sharded engine passes its multi-device step,
        and quantum (its device count) keeps every launched width a
        multiple of it."""
        n_live = len(rows)
        if n_live == 0:
            return []
        if screen_fn is None:
            screen_fn = self.screen_chunk
        if quantum > 1:
            chunk = max(quantum, (chunk // quantum) * quantum)
        else:
            chunk = min(chunk, n_live)
        ti = self.ti
        spans = [(c0, chunk) for c0 in range(0, n_live - chunk + 1, chunk)]
        rem = n_live - len(spans) * chunk
        if rem:
            bucket = min(chunk, max(8, 1 << (rem - 1).bit_length()))
            if quantum > 1:
                bucket = min(chunk, max(quantum,
                                        -(-bucket // quantum) * quantum))
            spans.append((n_live - rem, bucket))

        cand = []
        ckpt = _SweepCheckpoint.open(checkpoint, self, rows, cols, chunk)
        if ckpt is not None:
            cand.extend(ckpt.done_candidates)
            spans = [sp for sp in spans if sp not in ckpt.done_spans]
        try:
            for w0 in range(0, len(spans), wave):
                pending = []
                for c0, width in spans[w0:w0 + wave]:
                    take = min(width, n_live - c0)
                    r_chunk = np.pad(rows[c0:c0 + take], (0, width - take),
                                     constant_values=rows[-1])
                    c_chunk = np.pad(cols[c0:c0 + take], (0, width - take),
                                     constant_values=cols[-1])
                    hits, cnt = screen_fn(r_chunk, c_chunk)
                    pending.append(((c0, width), r_chunk, c_chunk, hits, cnt))
                counts = torch.cat([p[4] for p in pending]).cpu().numpy()
                pos = 0
                for span, r_chunk, c_chunk, hits, _ in pending:
                    width = len(r_chunk)
                    span_cand = []
                    ts = np.nonzero(counts[pos:pos + width])[0]
                    if ts.size:
                        for t, ri, cj in extract_hit_coords(hits, ts):
                            gi = int(r_chunk[t]) * ti + ri
                            gj = int(c_chunk[t]) * ti + cj
                            span_cand.extend(zip(gi.tolist(), gj.tolist()))
                    pos += width
                    cand.extend(span_cand)
                    if ckpt is not None:
                        ckpt.record(span, span_cand)
        finally:
            if ckpt is not None:
                ckpt.close()
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
            tau=self.params.tau, z_score=self.params.z_score,
            order_n=self.params.order_n, apply_cb=self.use_cb,
            hist_fn=hist_fn,
        )
        return oracle.confirm_pairs(cand)


def select_pairs_screened(bank, params, ti=None, chunk=None, device=None,
                          stats=None, checkpoint=None):
    """All-pairs selection via the fused screen + exact confirmation.

    Returns reference-ordered [(name_i, name_j, jacc)]. ti/chunk default
    to auto_tile/auto_chunk. stats: optional dict, filled with the wall
    seconds of each stage (plan, schedule, prune, screen, confirm), the
    plan's upload_secs (inside plan_secs) and the tile and candidate
    counts; the screen and prune walls end in a device-to-host copy, so
    they include the device work. checkpoint: the screen stage's progress
    file (ScreenPlan.screen_tiles). Each stage runs inside a
    torch.profiler.record_function span of its name (plan, schedule,
    prune, screen, confirm), which a trace shows; with the profiler off a
    span costs a few microseconds of host time."""
    if bank.n < 2:
        return []
    if ti is None:
        ti = auto_tile(bank.n)
    if chunk is None:
        chunk = auto_chunk(ti)
    st = {} if stats is None else stats
    span = torch.profiler.record_function
    t0 = time.perf_counter()
    with span("plan"):
        plan = ScreenPlan(bank, params, ti, device)
    t1 = time.perf_counter()
    with span("schedule"):
        rows, cols = plan.schedule()
    t2 = time.perf_counter()
    st.update(plan_secs=t1 - t0, upload_secs=plan.upload_secs,
              schedule_secs=t2 - t1, tiles_scheduled=len(rows))
    if not len(rows):
        return []
    with span("prune"):
        rows, cols = plan.prune_tiles(rows, cols, chunk=max(chunk, 256))
    t3 = time.perf_counter()
    with span("screen"):
        cand = plan.screen_tiles(rows, cols, chunk=chunk,
                                 checkpoint=checkpoint)
    t4 = time.perf_counter()
    with span("confirm"):
        confirmed = plan.confirm(cand)
    t5 = time.perf_counter()
    st.update(prune_secs=t3 - t2, screen_secs=t4 - t3, confirm_secs=t5 - t4,
              tiles_live=len(rows), candidates=len(cand),
              confirmed=len(confirmed))
    names = bank.names
    order = plan.order
    return [(names[order[i]], names[order[j]], jacc)
            for i, j, jacc in confirmed]


# --------------------------------------------------------------------------
# Multi-device: the tile list split over a ("rows",) mesh
# --------------------------------------------------------------------------


def make_sharded_screen_step(mesh, p, values, ti, n_bands, use_cb, use_smh,
                             aux=None):
    """The multi-device screen step: each chunk's tile list splits into one
    contiguous part per device of the mesh's rows axis, and each device
    screens its part against its own copy of the bank with the single
    device engine's chunk (_screen_chunk, K1; _screen_chunk_hllaux, K1 then
    K2 and the aux compare, when aux = (p_aux, values_aux)). No collective:
    survivors are independent per tile. Hits and counts are concatenated on
    `out_dev` in device order, so the chunk's tile order is kept.

    step(replicas, r_chunk, c_chunk, n_real, tau_scr, tau_cb, coef_aux,
         out_dev) -> (hits, counts)
      replicas: replicate_bank's list, one (regs, e, fp, aux_regs) per
        mesh position; r_chunk, c_chunk: numpy int32 tile ids, their
        length a multiple of the device count."""
    n_dev = mesh.shape["rows"]

    def step(replicas, r_chunk, c_chunk, n_real, tau_scr, tau_cb, coef_aux,
             out_dev):
        width = len(r_chunk) // n_dev
        hits, counts = [], []
        for d, (regs, e, fp, aux_regs) in enumerate(replicas):
            sl = slice(d * width, (d + 1) * width)
            rt = torch.from_numpy(np.ascontiguousarray(r_chunk[sl], np.int32)
                                  ).to(regs.device)
            ct = torch.from_numpy(np.ascontiguousarray(c_chunk[sl], np.int32)
                                  ).to(regs.device)
            if aux is None:
                h, c = _screen_chunk(regs, rt, ct, e, fp, n_real, tau_scr,
                                     tau_cb, p, values, ti, n_bands, use_cb,
                                     use_smh)
            else:
                h, c = _screen_chunk_hllaux(
                    regs, aux_regs, rt, ct, e, fp, n_real, tau_scr, tau_cb,
                    coef_aux, p, values, aux[0], aux[1], ti)
            hits.append(h.to(out_dev))
            counts.append(c.to(out_dev))
        return torch.cat(hits), torch.cat(counts)

    return step


def replicate_bank(mesh, *tensors):
    """One copy of the tensors on each distinct device of the mesh's rows
    axis, made once per plan (never per chunk); a device that appears
    several times shares its copy. Returns one tuple per mesh position."""
    copies = {}
    out = []
    for dev in mesh.devices("rows"):
        if dev not in copies:
            copies[dev] = tuple(None if t is None else t.to(dev)
                                for t in tensors)
        out.append(copies[dev])
    return out


def select_pairs_screened_sharded(bank, params, mesh=None, ti=512, chunk=64,
                                  checkpoint=None, wave=64, device=None,
                                  stats=None):
    """Multi-device screened all-pairs selection: the screened engine's
    cascade with each chunk's tiles split over the mesh (same exact-output
    contract, every criterion).

    mesh and device as parallel/mesh.resolve_mesh takes them; the plan
    (sort, schedule, gate prune, confirm) lives on the plan's device. The
    bank is copied to each distinct device of the mesh once. The sweep
    runs through ScreenPlan.screen_tiles with the multi-device step, so
    the chunk, wave and checkpoint loop is the single device engine's,
    with every launched width a multiple of the device count. stats: as select_pairs_screened's (plan_secs includes
    the bank's copies). Returns reference-ordered [(name_i, name_j,
    jacc)]."""
    from .mesh import resolve_mesh

    mesh, dev = resolve_mesh(mesh, device)
    if bank.n < 2:
        return []
    st = {} if stats is None else stats
    t0 = time.perf_counter()
    plan = ScreenPlan(bank, params, ti, dev)
    aux = (None if plan.coef_aux is None
           else (bank.aux_param, plan.values_aux))
    step = make_sharded_screen_step(mesh, bank.p, plan.values, ti,
                                    plan.n_bands, plan.use_cb, plan.use_smh,
                                    aux=aux)
    replicas = replicate_bank(mesh, plan.d_regs, plan.d_e, plan.d_fp,
                              plan.d_aux_regs)
    t1 = time.perf_counter()
    rows, cols = plan.schedule()
    t2 = time.perf_counter()
    st.update(plan_secs=t1 - t0, upload_secs=plan.upload_secs,
              schedule_secs=t2 - t1, tiles_scheduled=len(rows))
    if not len(rows):
        return []
    rows, cols = plan.prune_tiles(rows, cols)
    t3 = time.perf_counter()
    st.update(prune_secs=t3 - t2, tiles_live=len(rows))
    if not len(rows):
        return []

    def screen_fn(r_chunk, c_chunk):
        return step(replicas, r_chunk, c_chunk, plan.n, plan.tau_scr,
                    plan.tau_cb, plan.coef_aux, dev)

    cand = plan.screen_tiles(rows, cols, chunk=chunk, checkpoint=checkpoint,
                             wave=wave, screen_fn=screen_fn,
                             quantum=mesh.shape["rows"])
    t4 = time.perf_counter()
    confirmed = plan.confirm(cand)
    st.update(screen_secs=t4 - t3, confirm_secs=time.perf_counter() - t4,
              candidates=len(cand), confirmed=len(confirmed))
    names = bank.names
    order = plan.order
    return [(names[order[i]], names[order[j]], jacc)
            for i, j, jacc in confirmed]
