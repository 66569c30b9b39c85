"""Ring-rotated row-sharded screened engine: banks beyond replication.
Port of cuda_selection_criteria_tpu/parallel/ring.py.

The tile-sharded engine (parallel/screened.select_pairs_screened_sharded)
copies the whole register bank to every device. Past one device's memory
the bank itself must be split:

  * each device of a ("rows",) mesh (parallel/mesh.DeviceMesh) owns a
    contiguous STRIP of the ascending-cardinality sorted bank: registers
    (N/D, 2^p), cardinalities, LSH fingerprints, and for hll_a / hll_an the
    aux-HLL registers;
  * a copy of every strip circulates: at ring step s, device d screens its
    resident strip d against the circulating strip (d - s) mod D with K1's
    strip variant (ops/screen.screen_hits_fused_strips), then each
    circulating strip moves to device d + 1 (a device-to-device copy; on a
    mesh that repeats a device, the same tensor);
  * after D steps every ordered strip pair has been screened once on one
    device; the global i < j triangle gate keeps each pair once.

Hit masks are streamed: a step's tile list is launched in chunks of
`chunk_tiles` tiles, and the per-tile counts, then the hit tiles'
coordinates, are read every `wave` chunks, so a device holds at most
wave * chunk_tiles * ti^2 bytes of masks for each of its mesh positions
whatever N is.

Three exact schedule prunes run on the host: a ring step runs only on the
devices whose (resident, circulating) strip pair can hold an i < j pair
passing the cardinality bound; the step's tile list is the union over
those devices of their CB-live local tiles; the diagonal step (s = 0)
screens only upper-triangle tiles. A gate pass (_ring_gate_counts: CB,
triangle, LSH bands; the gate-count kernel on the card) then drops tiles
without a gate-passing pair before K1 runs.

Candidates go to the same exact confirmation as the other engines
(utils/hostref.PairOracle): on CUDA the candidates' rows are gathered from
their strips onto the plan's device and make_device_hist_fn computes their
union histograms there, so output lines are the reference's.
"""

import time

import numpy as np
import torch

from ..ops import criteria, screen
from ..utils.hostref import PairOracle
from .mesh import resolve_mesh
from .screened import (SCREEN_DELTA_AUX, Strip, _screen_strip_pair,
                       _strip_aux_pass, _strip_gate_counts, _strip_post,
                       auto_chunk, auto_tile, band_fingerprints_np,
                       extract_hit_coords, hll_aux_threshold_coef,
                       make_device_hist_fn, reject_delta_for, screen_tau,
                       upload_sorted_rows)

# Tiles per gate-pass call.
RING_GATE_CHUNK = 512

# The reference ring's names for the strip-pair screen forms, which every
# engine shares (parallel/screened).
_ring_gate_counts = _strip_gate_counts
_ring_aux_pass = _strip_aux_pass
_ring_post = _strip_post


def make_ring_fns(mesh, p, values, ti, n_bands, use_cb, use_smh, aux=None):
    """The ring's per-device primitives over a ("rows",) mesh.

    step(res, circ, r_tiles, c_tiles, n_real, tau_scr, tau_cb, coef_aux)
      -> (hits (C, ti, ti), counts (C,)) of one device: its resident strip
      res against the circulating strip circ, over LOCAL tile ids (units of
      ti rows inside each strip), on res's device: the screened engine's
      chunk over two strips (screened._screen_strip_pair), K1's strip
      variant when there are >= 2 present values, else K2 (screen_s_z with
      a column bank) and _ring_post. aux = (p_aux, values_aux) adds K2 at
      p_aux over the aux strips and the aux-union gate (_ring_aux_pass).
    gate(res, circ, r_tiles, c_tiles, n_real, tau_cb) -> int32 (C,) counts
      of gate-passing pairs (_ring_gate_counts).
    rotate(circs) -> circs moved one hop: device d + 1 receives device d's.

    The reference's diagonal variants (one strip operand, a workaround for
    an XLA memory budget) are the same call with the resident strip passed
    as both: K1 then packs its planes once.
    """
    devs = mesh.devices("rows")
    n_dev = len(devs)

    def step(res, circ, r_tiles, c_tiles, n_real, tau_scr, tau_cb,
             coef_aux):
        return _screen_strip_pair(res, circ, r_tiles, c_tiles, n_real,
                                  tau_scr, tau_cb, p, values, ti, n_bands,
                                  use_cb, use_smh, aux=aux,
                                  coef_aux=coef_aux)

    def gate(res, circ, r_tiles, c_tiles, n_real, tau_cb):
        return _strip_gate_counts(res.e, circ.e, res.fp, circ.fp, res.base,
                                  circ.base, r_tiles, c_tiles, n_real,
                                  tau_cb, n_bands, ti, use_cb, use_smh)

    def rotate(circs):
        return [circs[(d - 1) % n_dev].to(devs[d]) for d in range(n_dev)]

    return step, gate, rotate


def _strip_profile(e_p, n, n_dev, strip):
    """Per-strip (has_real, e_max, e_min_pos) from the sorted, padded
    cardinalities: the inputs of the strip-level CB liveness bound."""
    has_real = np.zeros(n_dev, bool)
    e_max = np.zeros(n_dev)
    e_min_pos = np.full(n_dev, np.inf)
    for d in range(n_dev):
        lo, hi = d * strip, min(n, (d + 1) * strip)
        if lo >= hi:
            continue
        has_real[d] = True
        seg = e_p[lo:hi]
        e_max[d] = float(seg[-1])  # ascending within the real rows
        pos = seg[seg > 0]
        if pos.size:
            e_min_pos[d] = float(pos[0])
    return has_real, e_max, e_min_pos


def _strip_hist_fn(resident, strip, rows, e_p, p, tau, delta, device):
    """make_device_hist_fn over the candidates' rows only: `rows` (sorted
    global positions) are gathered from their strips onto `device`, and
    the oracle's global (ii, kk) are mapped to that compact bank."""
    parts = []
    for d, res in enumerate(resident):
        local = rows[(rows >= d * strip) & (rows < (d + 1) * strip)] \
            - d * strip
        if local.size:
            idx = torch.from_numpy(local.astype(np.int64)).to(res.regs.device)
            parts.append(res.regs.index_select(0, idx).to(device))
    inner = make_device_hist_fn(
        torch.cat(parts), torch.from_numpy(e_p[rows]).to(device), p, tau,
        delta)

    def dispatch(ii, kk):
        return inner.dispatch(np.searchsorted(rows, ii),
                              np.searchsorted(rows, kk))

    def fn(ii, kk):
        return inner.fetch(dispatch(ii, kk))

    fn.dispatch = dispatch
    fn.fetch = inner.fetch
    fn.tau = inner.tau
    return fn


def select_pairs_ring(bank, params, mesh=None, ti=None, chunk_tiles=None,
                      stats=None, device=None, wave=64):
    """All-pairs selection with the bank split into strips over the mesh's
    devices (the ring sweep); same exact-output contract as the other
    engines, every criterion. Returns reference-ordered
    [(name_i, name_j, jacc)].

    mesh: a ("rows",) DeviceMesh; mesh and device as
    parallel/mesh.resolve_mesh takes them (the plan's device gathers the
    counts and runs the confirm). ti / chunk_tiles default to auto_tile of
    the strip's rows and auto_chunk. Counts and hits are read every `wave`
    chunks of a step, so a mesh position holds at most
    wave * chunk_tiles * ti^2 bytes of masks whatever N is. stats: optional
    dict, filled with the sweep's walls (upload_secs, schedule_secs,
    gate_secs, screen_secs, confirm_secs), upload_stats (the strips'
    register uploads' split, upload_sorted_rows's keys summed over the
    devices and rounded as the reference rounds them), counts (steps_total,
    steps_run, dispatches, tiles_dispatched, tiles_gate_live, candidates,
    strip, chunk_tiles, wave), max_device_mask_bytes (the largest sum of
    the hit masks one mesh position held at a read) and, when a mesh device
    is CUDA, max_wave_alloc_bytes: the most a device's allocator held at a
    read beyond what it held when the step loop began (the masks, counts
    and tile ids of its positions and, on a mesh of distinct devices, the
    circulating strip); None on CPU devices."""
    mesh, dev = resolve_mesh(mesh, device)
    devs = mesh.devices("rows")
    n_dev = len(devs)
    if ti is None:
        ti = auto_tile(-(-bank.n // n_dev))
    if chunk_tiles is None:
        chunk_tiles = auto_chunk(ti)
    crit = params.criterion
    valid = ("smh_a", "smh_only", "cb", "baseline", "hll_a", "hll_an")
    if crit not in valid:
        raise ValueError(f"ring engine does not support criterion {crit!r}")
    n = bank.n
    if n < 2:
        return []
    st = {} if stats is None else stats

    tau = params.tau_eff
    use_cb = crit not in ("baseline", "smh_only")
    use_smh = crit in ("smh_a", "smh_only")
    use_hllaux = crit in ("hll_a", "hll_an")

    order = bank.sorted_by_cardinality()
    e_s = np.trunc(bank.cards[order])
    aux_s = bank.aux[order] if bank.aux is not None else None

    # every strip a whole number of tiles
    quantum = n_dev * ti
    n_pad = -(-n // quantum) * quantum
    strip = n_pad // n_dev
    nt = strip // ti
    e_p = np.zeros(n_pad, np.float32)
    e_p[:n] = e_s

    if use_smh:
        n_rows_b, n_bands = criteria.smh_band_params(bank.aux_param,
                                                     params.tau)
        aux_p = np.zeros((n_pad, aux_s.shape[1]), aux_s.dtype)
        aux_p[:n] = aux_s
        fp = band_fingerprints_np(aux_p, n_rows_b, n_bands)
    else:
        n_bands = 1
        fp = np.zeros((n_pad, 1), np.int32)

    # hll-aux: the aux-HLL registers circulate as a second strip; no gate
    # (aux None) when it cannot prune at this tau
    coef = 0.0
    use_aux_gate = False
    if use_hllaux:
        zs = criteria.z_sigma(params.z_score, bank.aux_param)
        c = hll_aux_threshold_coef(crit, tau, zs, params.order_n)
        if c is not None:
            coef = c * (1.0 + SCREEN_DELTA_AUX)
            use_aux_gate = True

    # each strip through the slab-pipelined upload: the host never gathers
    # a whole strip, and a device holds its strips and no copy of them
    t0 = time.perf_counter()
    upload_ph = {}
    resident = []
    for d, dv in enumerate(devs):
        lo = d * strip
        resident.append(Strip(
            upload_sorted_rows(bank.regs, order, lo, strip, dv,
                               stats=upload_ph),
            (upload_sorted_rows(bank.aux, order, lo, strip, dv)
             if use_aux_gate else None),
            torch.from_numpy(e_p[lo:lo + strip]).to(dv),
            torch.from_numpy(np.ascontiguousarray(fp[lo:lo + strip])).to(dv),
            lo))
    # present values are permutation-invariant: the real rows of the strips
    # hold those of the bank
    real = [min(strip, max(0, n - d * strip)) for d in range(n_dev)]
    max_card = float(e_s.max(initial=1.0))
    values = screen.truncate_values(tuple(sorted(set().union(*(
        screen.bank_values(res.regs[:k]) for res, k in zip(resident, real)
        if k)))), max_card, bank.p)
    aux_spec = None
    if use_aux_gate:
        aux_spec = (bank.aux_param, screen.truncate_values(
            tuple(sorted(set().union(*(
                screen.bank_values(res.aux[:k])
                for res, k in zip(resident, real) if k)))),
            max_card, bank.aux_param))
    st["upload_secs"] = time.perf_counter() - t0
    st["upload_stats"] = {k: (round(v, 2) if isinstance(v, float) else v)
                          for k, v in upload_ph.items()}

    tau_scr = np.float32(screen_tau(tau, params.screen_delta))
    tau_cb = np.float32(tau * (1.0 - 1e-5))
    step, gate, rotate = make_ring_fns(mesh, bank.p, values, ti, n_bands,
                                       use_cb, use_smh, aux=aux_spec)

    # Strip-level liveness: device d runs step s only if its (resident d,
    # circulating (d-s) % D) pair can hold an i<j pair passing CB (a
    # one-sided bound in f64, relaxed like tau_cb).
    t0 = time.perf_counter()
    has_real, seg_max, seg_minpos = _strip_profile(e_p, n, n_dev, strip)
    tau_cb_host = float(tau) * (1.0 - 1e-5)

    def pair_live(d, src):
        if not (has_real[d] and has_real[src]) or src < d:
            return False  # no real rows, or gi < gj impossible
        if np.isinf(seg_minpos[src]):
            return False  # no positive-cardinality columns
        return not use_cb or seg_max[d] / seg_minpos[src] >= tau_cb_host

    # Per-step tiles at CB-block granularity: the union over the step's
    # live devices of their live local tile pairs (the screened scheduler's
    # bound per strip pair; every live device screens the union).
    k0_pos = int(np.searchsorted(e_s, 0.0, side="right"))
    g_starts = np.arange(n_dev * nt, dtype=np.int64) * ti
    first_idx = np.maximum(g_starts, k0_pos)
    has_pos = first_idx < np.minimum(g_starts + ti, n)
    tile_minpos = np.where(
        has_pos, e_p[np.minimum(first_idx, n_pad - 1)].astype(np.float64),
        np.inf).reshape(n_dev, nt)
    tile_emax = e_p.reshape(n_dev, nt, ti).astype(np.float64).max(-1)
    tile_row_live = (g_starts < n).reshape(n_dev, nt)
    triu = np.arange(nt)[:, None] <= np.arange(nt)[None, :]

    def step_tiles(s, live):
        union = np.zeros((nt, nt), bool)
        for d in live:
            src = (d - s) % n_dev
            m = (tile_row_live[d][:, None]
                 & np.isfinite(tile_minpos[src])[None, :])
            if use_cb:
                with np.errstate(invalid="ignore"):
                    m &= (tile_emax[d][:, None]
                          >= tau_cb_host * tile_minpos[src][None, :])
            if src == d:  # diagonal step: i<j kills below-diagonal tiles
                m &= triu
            union |= m
        rr, cc = np.nonzero(union)
        return rr.astype(np.int32), cc.astype(np.int32)

    st["schedule_secs"] = time.perf_counter() - t0
    chunk_tiles = max(1, min(chunk_tiles, nt * nt))
    st.update(steps_total=n_dev, steps_run=0, dispatches=0,
              max_device_mask_bytes=0, tiles_dispatched=0,
              tiles_gate_live=0, gate_secs=0.0, strip=strip,
              chunk_tiles=chunk_tiles, wave=wave)

    def on(devices, arr):
        """arr as an int32 tensor on each distinct device."""
        t = torch.from_numpy(np.ascontiguousarray(arr, np.int32))
        return {dv: t.to(dv) for dv in set(devices)}

    def launch(s, live, r_chunk, c_chunk):
        """One chunk on every live device: [(d, r, c, hits, counts)]."""
        rt = on([devs[d] for d in live], r_chunk)
        ct = on([devs[d] for d in live], c_chunk)
        return [(d, r_chunk, c_chunk, *step(
            resident[d], circ[d], rt[devs[d]], ct[devs[d]], n, tau_scr,
            tau_cb, coef)) for d in live]

    def read(s, pending):
        """The wave's counts in one read, then the hit tiles' pairs."""
        held = np.zeros(n_dev, np.int64)
        for d, *_, hits, _ in pending:
            held[d] += hits.nbytes
        st["max_device_mask_bytes"] = max(st["max_device_mask_bytes"],
                                          int(held.max()))
        for dv, a0 in alloc0.items():
            st["max_wave_alloc_bytes"] = max(
                st["max_wave_alloc_bytes"],
                torch.cuda.memory_allocated(dv) - a0)
        counts = torch.cat([c.to(dev) for *_, c in pending]).cpu().numpy()
        pos = 0
        for d, r_chunk, c_chunk, hits, _ in pending:
            ts = np.nonzero(counts[pos:pos + len(r_chunk)])[0]
            pos += len(r_chunk)
            src = (d - s) % n_dev
            for t, ri, cj in (extract_hit_coords(hits, ts) if ts.size
                              else ()):
                gi = d * strip + int(r_chunk[t]) * ti + ri
                gj = src * strip + int(c_chunk[t]) * ti + cj
                cand.extend(zip(gi.tolist(), gj.tolist()))

    cuda_devs = {dv for dv in devs if dv.type == "cuda"}
    st["max_wave_alloc_bytes"] = 0 if cuda_devs else None
    alloc0 = {dv: torch.cuda.memory_allocated(dv) for dv in cuda_devs}
    cand = []
    circ = resident  # step 0: each device against its own strip
    t_loop = time.perf_counter()
    for s in range(n_dev):
        live = [d for d in range(n_dev) if pair_live(d, (d - s) % n_dev)]
        r_all, c_all = step_tiles(s, live) if live else ([], [])
        st["tiles_dispatched"] += len(r_all)
        if len(r_all) and (use_cb or use_smh):
            # the gate pass over the step's tiles, one count read: tiles
            # with no gate-passing pair on any live device never reach K1
            t_gate = time.perf_counter()
            gcounts = []
            for c0 in range(0, len(r_all), RING_GATE_CHUNK):
                sl = slice(c0, c0 + RING_GATE_CHUNK)
                rt = on([devs[d] for d in live], r_all[sl])
                ct = on([devs[d] for d in live], c_all[sl])
                gcounts.append(torch.stack([gate(
                    resident[d], circ[d], rt[devs[d]], ct[devs[d]], n,
                    tau_cb).to(dev) for d in live]))
            keep = torch.cat(gcounts, 1).cpu().numpy().any(0)
            r_all, c_all = r_all[keep], c_all[keep]
            st["tiles_gate_live"] += len(r_all)
            st["gate_secs"] += time.perf_counter() - t_gate
        if len(r_all):
            starts = range(0, len(r_all), chunk_tiles)
            for w0 in range(0, len(starts), wave):
                pending = []
                for c0 in starts[w0:w0 + wave]:
                    pending += launch(s, live, r_all[c0:c0 + chunk_tiles],
                                      c_all[c0:c0 + chunk_tiles])
                    st["dispatches"] += 1
                read(s, pending)
                del pending
            st["steps_run"] += 1
        if s < n_dev - 1:
            circ = rotate(circ)
    cand = sorted(set(cand))
    # screen wall disjoint from the gate wall (both inside the step loop)
    st["screen_secs"] = time.perf_counter() - t_loop - st["gate_secs"]
    st["candidates"] = len(cand)

    t0 = time.perf_counter()
    hist_fn = None
    if cand and dev.type == "cuda":
        hist_fn = _strip_hist_fn(
            resident, strip, np.unique(np.asarray(cand, np.int64)), e_p,
            bank.p, float(params.tau),
            reject_delta_for(bank.p, params.screen_delta), dev)
    oracle = PairOracle(
        bank.p, (lambda: bank.regs[order]), e_s, aux=aux_s,
        aux_param=bank.aux_param, criterion=crit, tau=params.tau,
        z_score=params.z_score, order_n=params.order_n, apply_cb=use_cb,
        hist_fn=hist_fn)
    names = bank.names
    out = [(names[order[i]], names[order[j]], jacc)
           for i, j, jacc in oracle.confirm_pairs(cand)]
    st["confirm_secs"] = time.perf_counter() - t0
    return out
