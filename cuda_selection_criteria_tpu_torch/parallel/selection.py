"""All-pairs similar-genome selection: parameters, engine dispatch, the
dense exact engine and the reference's output format. Port of
cuda_selection_criteria_tpu/parallel/selection.py.

The dense engine tiles the i<j triangle of the cardinality-sorted bank
into (row-block, col-block) tiles and, per tile, computes

    CB mask & auxiliary-criterion mask (smh_a bands / hll_a / hll_an)
  & triangle + zero-cardinality masks
  -> indicator-product union histograms -> batched ERTL-MLE -> J >= tau

for every pair of the tile (ops/pairwise, ops/criteria, ops/estimators:
plain torch ops, no hand-written kernel). Results come out in the
reference's sorted-row order, and by default every candidate is decided
again by the exact host oracle (utils/hostref.PairOracle).
"""

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import criteria, pairwise
from ..utils.device import as_tensor, resolve
from ..utils.hostref import PairOracle
from . import scheduler
from .mesh import mesh_devices
from .ring import select_pairs_ring
from .screened import (make_device_hist_fn, reject_delta_for,
                       select_pairs_screened)

Z_SCORE_DEFAULT = 1.96  # src/selection.cpp:76
ORDER_N_DEFAULT = 1  # src/selection.cpp:77

ENGINES = ("auto", "screened", "dense", "ring")

# The auto engine leaves the screened engine for the ring when the padded
# register bank exceeds this share of one card's memory on a host of
# several cards (the reference's replication threshold).
RING_BANK_SHARE = 0.55


@dataclass(frozen=True)
class SelectionParams:
    """Same fields as the reference package's SelectionParams, so a
    parameter set carries across unchanged. The screened engine reads tau,
    criterion and screen_delta, and for hll_a / hll_an also z_score and
    order_n; the dense engine reads block, precision, screen_margin,
    adjudicate and screen_dtype besides. confirm is carried for parity
    (neither package's engines read it)."""

    tau: float  # raw user threshold; effective f32->f64 applied internally
    criterion: str = "smh_a"
    aux_bytes: int = 256
    z_score: float = Z_SCORE_DEFAULT
    order_n: int = ORDER_N_DEFAULT
    block: int = 512
    precision: str = "bf16"
    confirm: str = "fused"
    # Dense engine: every device threshold comparison is relaxed by this
    # margin and the candidates are decided again exactly on the host, so
    # the emitted pairs do not depend on the device MLE's last bits.
    screen_margin: float = 1e-4
    adjudicate: bool = True
    # Device-MLE dtype of the dense engine: "auto" is f64 on a CPU device
    # and f32 on CUDA (covered by the margin and adjudication).
    screen_dtype: str = "auto"
    # Numeric slack on the certified screen threshold (parallel.screened):
    # covers only f32 rounding of the screen statistic.
    screen_delta: float = 1e-3
    # "auto" runs the screened engine on CUDA when adjudicating (the ring
    # past one card's memory on several cards), else the dense engine;
    # "screened" / "dense" / "ring" force one.
    engine: str = "auto"

    def resolve_dtype(self, device=None):
        """The dense engine's MLE dtype on `device` (None means CUDA)."""
        if self.screen_dtype == "auto":
            return (torch.float64 if resolve(device).type == "cpu"
                    else torch.float32)
        return {"f32": torch.float32, "f64": torch.float64}[self.screen_dtype]

    @property
    def tau_eff(self):
        return criteria.effective_tau(self.tau)


# --------------------------------------------------------------------------
# Per-tile steps (one per criterion family)
# --------------------------------------------------------------------------


def _tile_gates(e_a, e_b, idx_a, idx_b):
    tri = ((idx_a[:, None] < idx_b[None, :]) & (idx_a[:, None] >= 0)
           & (idx_b[None, :] >= 0))
    return tri & (e_b[None, :] != 0)


def _tile_hits(gate, regs_a, regs_b, e_a, e_b, tau, p, precision, mle_dtype):
    jacc, _ = pairwise.pairwise_jaccard(regs_a, regs_b, e_a, e_b, p,
                                        precision, mle_dtype)
    # tau is an f64 scalar in the reference: an f32 Jaccard is widened
    return gate & (jacc.to(torch.float64) >= tau), jacc


def _tile_no_aux(regs_a, regs_b, e_a, e_b, idx_a, idx_b, tau, p, precision,
                 mle_dtype, apply_cb):
    gate = _tile_gates(e_a, e_b, idx_a, idx_b)
    if apply_cb:
        gate = gate & criteria.cb_mask(e_a, e_b, tau)
    return _tile_hits(gate, regs_a, regs_b, e_a, e_b, tau, p, precision,
                      mle_dtype)


def _tile_smh(regs_a, regs_b, aux_a, aux_b, e_a, e_b, idx_a, idx_b, tau, p,
              n_rows, n_bands, precision, mle_dtype, apply_cb):
    gate = (_tile_gates(e_a, e_b, idx_a, idx_b)
            & criteria.smh_a_mask(aux_a, aux_b, n_rows, n_bands))
    if apply_cb:
        gate = gate & criteria.cb_mask(e_a, e_b, tau)
    return _tile_hits(gate, regs_a, regs_b, e_a, e_b, tau, p, precision,
                      mle_dtype)


def _tile_hll_aux(regs_a, regs_b, aux_a, aux_b, e_a, e_b, idx_a, idx_b, tau,
                  zs, p, p_aux, kind, order_n, precision,
                  mle_dtype=torch.float64):
    gate = (_tile_gates(e_a, e_b, idx_a, idx_b)
            & criteria.cb_mask(e_a, e_b, tau))
    if kind == "hll_a":
        aux_gate = criteria.hll_a_mask(aux_a, aux_b, e_a, e_b, tau, zs,
                                       p_aux, precision, mle_dtype)
    else:
        aux_gate = criteria.hll_an_mask(aux_a, aux_b, e_a, e_b, tau, zs,
                                        p_aux, order_n, precision, mle_dtype)
    return _tile_hits(gate & aux_gate, regs_a, regs_b, e_a, e_b, tau, p,
                      precision, mle_dtype)


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------


def _pad_rows(arr, lo, hi, block, fill=0):
    """Slice rows [lo, hi) padded up to `block` rows."""
    sl = arr[lo:hi]
    if sl.shape[0] == block:
        return sl
    pad = [(0, block - sl.shape[0])] + [(0, 0)] * (sl.ndim - 1)
    return np.pad(sl, pad, constant_values=fill)


def select_pairs(bank, params, device=None, stats=None, checkpoint=None):
    """All-pairs selection on a SketchBank; returns reference-ordered
    [(name_i, name_j, jacc)] (src/selection.cpp:297-300).

    device: where the engine runs; None means CUDA (utils/device.resolve);
    for the ring None or "cuda" means every CUDA device
    (parallel/mesh.resolve_mesh).
    stats: optional dict of stage walls and counts (each engine's own).
    checkpoint: sweep progress file of the screened engine."""
    if params.engine not in ENGINES:
        raise ValueError(f"unknown engine {params.engine!r}; the port has "
                         f"{', '.join(ENGINES)}")
    if bank.n < 2:
        return []
    engine = params.engine
    if engine == "auto":
        # the screened engine always ends in exact host adjudication
        on_cuda = resolve(device).type == "cuda"
        engine = "screened" if on_cuda and params.adjudicate else "dense"
        # past replication the bank itself must be split over the cards
        if (engine == "screened" and mesh_devices(device) is None
                and torch.cuda.device_count() > 1):
            total = torch.cuda.get_device_properties(0).total_memory
            if bank.n * bank.regs.shape[1] > RING_BANK_SHARE * total:
                engine = "ring"
    if engine == "ring":
        return select_pairs_ring(bank, params, stats=stats, device=device)
    if engine == "screened":
        return select_pairs_screened(bank, params, device=device, stats=stats,
                                     checkpoint=checkpoint)
    return select_pairs_dense(bank, params, device=device, stats=stats)


def select_pairs_dense(bank, params, device=None, stats=None):
    """The dense exact engine (the reference package's select_pairs body
    for engine="dense"). The sorted bank is padded to whole blocks and
    uploaded once; a tile's padded rows are slices of it (e = 0, index -1,
    as _pad_rows fills them per tile in the reference).

    stats: optional dict, filled with plan_secs (sort, pad, upload),
    tile_secs (every tile, ending in each tile's hit read), confirm_secs,
    tiles, candidates and confirmed."""
    dev = resolve(device)
    st = {} if stats is None else stats
    t0 = time.perf_counter()
    n = bank.n
    tau = params.tau_eff
    # Device threshold relaxed by the margin; candidates are decided again
    # exactly on the host below.
    tau_dev = tau - params.screen_margin if params.adjudicate else tau
    order = bank.sorted_by_cardinality()
    e_s = np.trunc(bank.cards[order])  # size_t truncation semantics
    regs_s = bank.regs[order]
    aux_s = bank.aux[order] if bank.aux is not None else None

    block = min(params.block, max(8, n))
    crit = params.criterion
    use_cb = crit not in ("baseline", "smh_only")
    tiles = scheduler.triangle_blocks(e_s, tau_dev, block, use_cb_skip=use_cb)
    if crit in ("smh_a", "smh_only"):
        n_rows, n_bands = criteria.smh_band_params(bank.aux_param, params.tau)
    elif crit in ("hll_a", "hll_an"):
        zs = criteria.z_sigma(params.z_score, bank.aux_param)
    elif crit not in ("cb", "baseline"):
        raise ValueError(f"unknown criterion {crit!r}")
    mle_dtype = params.resolve_dtype(dev)

    n_pad = -(-n // block) * block
    d_regs = as_tensor(_pad_rows(regs_s, 0, n, n_pad), torch.uint8, dev)
    d_e = as_tensor(_pad_rows(e_s, 0, n, n_pad), torch.float64, dev)
    d_idx = as_tensor(_pad_rows(np.arange(n), 0, n, n_pad, fill=-1),
                      torch.int64, dev)
    if crit not in ("cb", "baseline"):
        d_aux = as_tensor(_pad_rows(aux_s, 0, n, n_pad),
                          torch.int64 if aux_s.dtype == np.uint64
                          else torch.uint8, dev)
    t1 = time.perf_counter()

    def rows(arr, r0):
        return arr[r0:r0 + block]

    results = []
    for (r0, _), (c0, _) in tiles:
        ra, rb = rows(d_regs, r0), rows(d_regs, c0)
        ea, eb = rows(d_e, r0), rows(d_e, c0)
        ia, ib = rows(d_idx, r0), rows(d_idx, c0)
        if crit in ("cb", "baseline"):
            hits, jacc = _tile_no_aux(
                ra, rb, ea, eb, ia, ib, tau_dev, bank.p, params.precision,
                mle_dtype, apply_cb=use_cb)
        elif crit in ("smh_a", "smh_only"):
            hits, jacc = _tile_smh(
                ra, rb, rows(d_aux, r0), rows(d_aux, c0), ea, eb, ia, ib,
                tau_dev, bank.p, n_rows, n_bands, params.precision,
                mle_dtype, apply_cb=use_cb)
        else:
            hits, jacc = _tile_hll_aux(
                ra, rb, rows(d_aux, r0), rows(d_aux, c0), ea, eb, ia, ib,
                tau_dev, zs, bank.p, bank.aux_param, crit, params.order_n,
                params.precision, mle_dtype=mle_dtype)
        ij = torch.nonzero(hits)  # row-major, like np.nonzero
        if ij.shape[0]:
            vals = jacc[ij[:, 0], ij[:, 1]].cpu().tolist()
            for (i_loc, j_loc), j_val in zip(ij.cpu().tolist(), vals):
                results.append((r0 + i_loc, c0 + j_loc, float(j_val)))
    t2 = time.perf_counter()

    results.sort(key=lambda t: (t[0], t[1]))
    names = bank.names
    st.update(plan_secs=t1 - t0, tile_secs=t2 - t1, tiles=len(tiles),
              candidates=len(results))
    if not params.adjudicate:
        st.update(confirm_secs=0.0, confirmed=len(results))
        return [(names[order[i]], names[order[j]], j_val)
                for i, j, j_val in results]
    hist_fn = None
    if dev.type == "cuda":
        # device union histograms with the certified reject flag, as the
        # screened engine's confirm stage (parallel/screened.ScreenPlan)
        hist_fn = make_device_hist_fn(
            d_regs, d_e.to(torch.float32), bank.p, float(params.tau),
            reject_delta_for(bank.p, params.screen_delta))
    oracle = PairOracle(
        bank.p, regs_s, e_s, aux=aux_s, aux_param=bank.aux_param,
        criterion=crit, tau=params.tau, z_score=params.z_score,
        order_n=params.order_n, apply_cb=use_cb, hist_fn=hist_fn,
    )
    final = oracle.confirm_pairs([(i, j) for i, j, _ in results])
    st.update(confirm_secs=time.perf_counter() - t2, confirmed=len(final))
    return [(names[order[i]], names[order[j]], jacc)
            for i, j, jacc in final]


def format_results(results):
    """Output lines exactly like the reference: `fileA fileB J` with
    std::to_string's fixed 6 decimals (src/selection.cpp:170)."""
    return [f"{a} {b} {j:.6f}" for a, b, j in results]
