"""Device meshes and the dense multi-device selection step. Port of
cuda_selection_criteria_tpu/parallel/mesh.py.

The reference package drives every device from one process through
shard_map; the port does the same with a single-process mesh: a numpy array
of torch.device with one name per axis, one tensor per device, and Python
loops where shard_map ran its program on each device. A device may appear
more than once (["cuda:0"] * 4 runs four virtual devices on one card, as
the reference's tests run eight virtual CPU devices), so code over a mesh
never writes into a tensor that another mesh position may share.

  * axis "rows": each device owns a strip of the ascending-cardinality
    sorted rows and compares it with the whole column bank.
  * axis "regs": the 2^p register axis of the primary bank is split; each
    device computes the CDF sums of its register slice, and a row's slices
    are summed as int32 on the row's device (the reference's psum over
    "regs"; integer sums are exact in any order).

torch.distributed is not used here: only parallel/distributed.py, the
multi-host tile slices, runs across processes.
"""

import numpy as np
import torch

from ..ops import criteria, estimators, pairwise
from ..utils.device import as_tensor
from ..utils.hostref import PairOracle


class DeviceMesh:
    """A numpy object array of torch.device with one axis name per
    dimension: `devices` in mesh order, reshaped to `shape` (default one
    axis). shape[axis] is the axis' length; devices(axis) the devices along
    it at index 0 of the other axes, devices() all of them in mesh order."""

    def __init__(self, devices, axis_names=("rows",), shape=None):
        flat = [torch.device(d) for d in devices]
        arr = np.empty(len(flat), object)
        arr[:] = flat
        self.array = arr.reshape(shape or (len(flat),))
        self.axis_names = tuple(axis_names)
        if self.array.ndim != len(self.axis_names) or not flat:
            raise ValueError(f"axes {self.axis_names} need a non-empty "
                             f"device array of as many dimensions, got "
                             f"shape {self.array.shape}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.array.shape))

    def devices(self, axis=None):
        if axis is None:
            return list(self.array.ravel())
        idx = [0] * self.array.ndim
        idx[self.axis_names.index(axis)] = slice(None)
        return list(self.array[tuple(idx)])

    def __repr__(self):
        return (f"DeviceMesh({self.shape}, "
                f"{[str(d) for d in self.devices()]})")


def cuda_devices():
    """Every CUDA device of this process; raises without one (a mesh has
    no CPU fallback: CPU meshes are asked for by name)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass devices=[...] for a CPU "
                           "mesh")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_rows=None, n_regs=None, devices=None):
    """A ("rows", "regs") mesh over `devices` (default: every CUDA device),
    both axes split when the count is even (the reference's rule)."""
    devices = cuda_devices() if devices is None else list(devices)
    n = len(devices)
    if n_rows is None and n_regs is None:
        n_regs = 2 if n % 2 == 0 and n > 1 else 1
        n_rows = n // n_regs
    elif n_rows is None:
        n_rows = n // n_regs
    elif n_regs is None:
        n_regs = n // n_rows
    if n_rows * n_regs != n:
        raise ValueError(f"mesh {n_rows}x{n_regs} != {n} devices")
    return DeviceMesh(devices, ("rows", "regs"), (n_rows, n_regs))


def row_mesh(devices=None):
    """A 1-D ("rows",) mesh (the ring and tile-sharded engines) over
    `devices`, default every CUDA device."""
    return DeviceMesh(cuda_devices() if devices is None else devices)


def mesh_devices(device):
    """The devices of a mesh-less multi-device call: None (every CUDA
    device) for device None or "cuda" without an index, else [device]."""
    if device is None or torch.device(device) == torch.device("cuda"):
        return None
    return [device]


def resolve_mesh(mesh, device=None):
    """(mesh, the plan's device) of a multi-device engine. mesh None means
    a row mesh of every CUDA device when device is None or "cuda", else of
    `device` alone. The plan's device (sorted cardinalities, gathered hits,
    the confirm) is the one named with an index or "cpu", else the mesh's
    first."""
    if mesh is None:
        mesh = row_mesh(mesh_devices(device))
    named = mesh_devices(device)
    return mesh, (mesh.devices()[0] if named is None
                  else torch.device(device))


def sharded_selection_step(mesh, p, criterion, n_rows_band=1, n_bands=1,
                           p_aux=None, precision="bf16"):
    """The dense multi-device selection step for any criterion (reference
    coverage: src/selection.cpp:122-291). It materialises (N/rows, N, q+1)
    CDF sums per row strip, so it suits banks whose full (N, N) mask fits,
    as in the reference package.

    step(regs_rows, regs_cols, aux_rows, aux_cols, e_rows, e_cols,
         idx_rows, idx_cols, tau, coef_aux) -> (hits, jacc)
      regs_*: uint8 (N, 2^p); N divides into mesh.shape["rows"] strips and
        2^p into mesh.shape["regs"] slices;
      aux_*: SMH buckets (int64) or aux-HLL registers (uint8), (N, m);
      e_*: f64 truncated cardinalities; idx_*: int64 sorted positions, -1
        on padded rows; tau, coef_aux: floats (coef_aux <= 0 disables the
        hll_a / hll_an aux gate t_aux <= coef*(e1+e2) + slack, a superset
        of the exact gate that the host adjudicates).
    Returns hits bool (N, N) and jacc f64 (N, N) on the mesh's first
    device. Each (rows, regs) cell computes ops/pairwise.cdf_matmul over its
    register slice; the slices of a row strip are summed as int32 on the
    strip's first device, then the histograms, the f64 ERTL-MLE and the
    gates run there, as the reference's step does per shard."""
    r_total = 1 << p
    use_cb = criterion not in ("baseline", "smh_only")
    use_smh = criterion in ("smh_a", "smh_only")
    use_hllaux = criterion in ("hll_a", "hll_an")
    grid = mesh.array
    d_rows, d_regs = mesh.shape["rows"], mesh.shape["regs"]
    out_dev = mesh.devices()[0]

    def step(regs_rows, regs_cols, aux_rows, aux_cols, e_rows, e_cols,
             idx_rows, idx_cols, tau, coef_aux):
        n, r = regs_rows.shape
        if n % d_rows or r % d_regs:
            raise ValueError(f"({n}, {r}) does not split over the "
                             f"{d_rows} x {d_regs} mesh")
        rs, gs = n // d_rows, r // d_regs
        cols = {}  # (device, slice) -> the column bank's register slice
        hits_out, jacc_out = [], []
        for ri in range(d_rows):
            row_dev = grid[ri, 0]
            rows = slice(ri * rs, (ri + 1) * rs)
            cdf = None
            for gi in range(d_regs):
                dev = grid[ri, gi]
                regs = slice(gi * gs, (gi + 1) * gs)
                if (dev, gi) not in cols:
                    cols[dev, gi] = regs_cols[:, regs].contiguous().to(dev)
                part = pairwise.cdf_matmul(
                    regs_rows[rows, regs].contiguous().to(dev), cols[dev, gi],
                    p, precision).to(torch.int32).to(row_dev)
                cdf = part if cdf is None else cdf + part
            counts = pairwise.counts_from_cdf(cdf.to(torch.float32), r_total)
            t = estimators.ertl_mle(counts, p)
            e1 = torch.trunc(e_rows[rows].to(row_dev, torch.float64))[:, None]
            e2 = torch.trunc(e_cols.to(row_dev, torch.float64))[None, :]
            jacc = (e1 + e2 - t) / t
            ia = idx_rows[rows].to(row_dev)[:, None]
            ib = idx_cols.to(row_dev)[None, :]
            gate = (ia < ib) & (ia >= 0) & (ib >= 0) & (e2 != 0)
            if use_cb:
                gate &= (e1 / e2) >= tau
            if use_smh:
                gate &= criteria.smh_a_mask(aux_rows[rows].to(row_dev),
                                            aux_cols.to(row_dev),
                                            n_rows_band, n_bands)
            if use_hllaux and coef_aux > 0:
                t_a = estimators.ertl_mle(pairwise.union_histograms(
                    aux_rows[rows].to(row_dev), aux_cols.to(row_dev), p_aux,
                    precision), p_aux)
                # +1 absolute slack for the exact gate's size_t truncation,
                # a small relative margin for the device MLE
                gate &= t_a <= (coef_aux * (e1 + e2) + 1.0) * (1.0 + 1e-6)
            hits_out.append((gate & (jacc >= tau)).to(out_dev))
            jacc_out.append(jacc.to(out_dev))
        return torch.cat(hits_out), torch.cat(jacc_out)

    return step


def sharded_smh_selection_step(mesh, p, n_rows_band, n_bands,
                               precision="bf16"):
    """The CB + smh_a specialisation of sharded_selection_step (the
    reference's 9-argument signature)."""
    inner = sharded_selection_step(mesh, p, "smh_a", n_rows_band, n_bands,
                                   precision=precision)

    def step(regs_rows, regs_cols, aux_rows, aux_cols, e_rows, e_cols,
             idx_rows, idx_cols, tau):
        return inner(regs_rows, regs_cols, aux_rows, aux_cols, e_rows,
                     e_cols, idx_rows, idx_cols, tau, 0.0)

    return step


def select_pairs_sharded(bank, params, mesh=None, device=None):
    """Dense multi-device all-pairs selection, every criterion; returns
    reference-ordered [(name_i, name_j, jacc)].

    Pads the sorted bank to the rows axis, runs the step and extracts the
    hits in sorted order. mesh None: make_mesh over every CUDA device when
    device is None or "cuda", else over `device` alone. hll_a / hll_an are always
    adjudicated on the host (their device aux gate is a superset); the
    other criteria follow params.adjudicate. Suits banks whose (N, N) mask
    fits; the tile engines handle larger N."""
    from .screened import hll_aux_threshold_coef

    if mesh is None:
        mesh = make_mesh(devices=mesh_devices(device))
    crit = params.criterion
    valid = ("smh_a", "smh_only", "cb", "baseline", "hll_a", "hll_an")
    if crit not in valid:
        raise ValueError(f"sharded engine does not support criterion {crit!r}")
    use_cb = crit not in ("baseline", "smh_only")
    use_smh = crit in ("smh_a", "smh_only")
    use_hllaux = crit in ("hll_a", "hll_an")
    adjudicate = bool(params.adjudicate or use_hllaux)
    if use_smh and bank.aux_kind != "smh":
        raise ValueError("smh criteria require an smh aux bank")
    if use_hllaux and bank.aux_kind != "hll":
        raise ValueError("hll_a/hll_an require an hll aux bank")
    if bank.n < 2:
        return []

    tau = params.tau_eff
    order = bank.sorted_by_cardinality()
    n = bank.n
    n_pad = -(-n // mesh.shape["rows"]) * mesh.shape["rows"]

    def pad(a, fill=0):
        width = [(0, n_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    regs_s = pad(bank.regs[order])
    aux_s = (pad(bank.aux[order]) if bank.aux is not None
             else np.zeros((n_pad, 8), np.uint8))
    e_s = pad(np.trunc(bank.cards[order]))
    idx = pad(np.arange(n), fill=-1)
    cpu = torch.device("cpu")
    t_regs = as_tensor(regs_s, torch.uint8, cpu)
    t_aux = as_tensor(aux_s, torch.int64 if aux_s.dtype == np.uint64
                      else torch.uint8, cpu)
    t_e = as_tensor(e_s, torch.float64, cpu)
    t_idx = as_tensor(idx, torch.int64, cpu)

    tau_dev = tau - params.screen_margin if adjudicate else tau
    nrb = nbd = 1
    if use_smh:
        nrb, nbd = criteria.smh_band_params(bank.aux_param, params.tau)
    coef = 0.0
    if use_hllaux:
        zs = criteria.z_sigma(params.z_score, bank.aux_param)
        c = hll_aux_threshold_coef(crit, tau, zs, params.order_n)
        coef = 0.0 if c is None else c * (1.0 + 1e-6)
    step = sharded_selection_step(
        mesh, bank.p, crit, nrb, nbd,
        p_aux=(bank.aux_param if use_hllaux else None),
        precision=params.precision)
    hits, jacc = step(t_regs, t_regs, t_aux, t_aux, t_e, t_e, t_idx, t_idx,
                      float(tau_dev), float(coef))
    ij = torch.nonzero(hits).cpu().numpy()  # row-major: sorted order
    names = bank.names
    if adjudicate:
        oracle = PairOracle(
            bank.p, regs_s, e_s,
            aux=(aux_s if bank.aux is not None else None),
            aux_param=bank.aux_param, criterion=crit, tau=params.tau,
            z_score=params.z_score, order_n=params.order_n,
            apply_cb=use_cb)
        return [(names[order[i]], names[order[j]], jacc_exact)
                for i, j, jacc_exact in oracle.confirm_pairs(
                    map(tuple, ij.tolist()))]
    vals = jacc[hits].cpu().tolist()
    return [(names[order[i]], names[order[j]], float(v))
            for (i, j), v in zip(ij.tolist(), vals)]
