#!/usr/bin/env python3
"""The split of the torch port's screened plan (parallel/screened.
ScreenPlan.__init__) into its steps, on a benchmark cell's bank, on the
card and its host.

    python3 experiments/plan_split.py [--cells smh_a-524k hll_a-16k]
                                      [--seed 0] [--reps 3]

The bank is the cell's (benchmark/bank.py from --seed, as python3 -m
benchmark.run makes it). One JSON line a cell, each step the best wall of
--reps runs on the host clock, each ending in the host array or in a
synchronize:

  - the plan's own steps: the primary bank's upload (upload_sorted_rows,
    unsorted, one zero row), the row histograms and the cards
    (screen.row_hist, bank.cards_from_hists), the stable argsort
    (sorted_by_cardinality), the sorted e and the map d_rows with their
    copies to the card;
  - the fingerprints of a smh cell by two routes, both bit-equal: the
    host route the plan took before the fingerprint kernel (the sorted
    aux gather bank.aux[order], the zero-padded copy, band_fingerprints_np
    and the copy of its result to the card) and the card route it takes
    now (the aux bank's unsorted upload with one zero row, the kernel
    through d_rows, CUDA events for the kernel alone, and the free);
  - a hll cell's sorted aux gather (its confirm's copy);
  - ScreenPlan as a whole on a bank without cards, as a timed rep of the
    cell builds it, with its upload_secs, cards_secs and fp_secs and the
    rest of its wall;
  - the pack stage (pack_planes_kernel) at the cell's own screen launches
    (the plan's schedule, its gate prune, then screen_tiles as
    select_pairs_screened runs it): each K1 launch's distinct row blocks
    (screen.block_slots, counted as launch_tiles builds them) and, for a
    hll cell, K2's whole aux bank a launch; the bound is those rows read
    once and their planes written once at HBM_BYTES_PER_S, beside the
    pack's device time in a torch.profiler trace of one screen_tiles.

The card's name and power limit ride in each line. Needs a CUDA card;
exits 1 unless the two routes give the same fingerprints.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def best(fn, reps):
    """(best seconds of reps runs, the last result)."""
    secs = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        secs = min(secs, time.perf_counter() - t0)
    return secs, out


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip() or None


def split(torch, cell, seed, reps):
    """One cell's JSON record; rec["bit_equal"] says whether both
    fingerprint routes agreed."""
    from benchmark import bank as bank_mod
    from cuda_selection_criteria_tpu_torch.models import SketchBank
    from cuda_selection_criteria_tpu_torch.models.bank import cards_from_hists
    from cuda_selection_criteria_tpu_torch.ops import criteria, screen
    from cuda_selection_criteria_tpu_torch.parallel import screened
    from cuda_selection_criteria_tpu_torch.parallel.selection import (
        SelectionParams)

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    b = bank_mod.make_bank(cell.n, cell.aux_kind, cell.aux_param,
                           cell.planted, seed)
    n = len(b.regs)
    ti = screened.auto_tile(n)
    n_pad = -(-n // ti) * ti
    rec = {"cell": cell.name, "seed": seed, "n": n, "n_pad": n_pad,
           "bank_secs": time.perf_counter() - t0,
           "cores": os.cpu_count(), "card": card()}

    def upload():
        return screened.upload_sorted_rows(b.regs, None, 0, n + 1, dev)

    rec["upload_secs"], d_bank = best(upload, reps)

    def cards():
        hists, _ = screen.row_hist(d_bank[:n])
        return cards_from_hists(hists, b.p)[0]

    rec["cards_secs"], bank_cards = best(cards, reps)
    bank = SketchBank(names=b.names, regs=b.regs, p=b.p, cards=bank_cards,
                      aux=b.aux, aux_kind=b.aux_kind,
                      aux_param=b.aux_param)
    rec["argsort_secs"], order = best(bank.sorted_by_cardinality, reps)

    def sorted_e_and_map():
        rows = np.full(n_pad, n, np.int32)
        rows[:n] = order
        e_p = np.zeros(n_pad, np.float32)
        e_p[:n] = np.trunc(bank_cards[order])
        d_rows, d_e = (torch.from_numpy(x).to(dev) for x in (rows, e_p))
        sync()
        return d_rows, d_e

    rec["e_and_map_secs"], (d_rows, _) = best(sorted_e_and_map, reps)
    del d_bank
    torch.cuda.empty_cache()

    rec["bit_equal"] = True
    if cell.aux_kind == "smh":
        n_rows, n_bands = criteria.smh_band_params(cell.aux_param, cell.tau)
        rec.update(m=cell.aux_param, n_rows=n_rows, n_bands=n_bands)
        rec["host_gather_secs"], aux_s = best(lambda: bank.aux[order], reps)

        def pad():
            aux_p = np.zeros((n_pad, aux_s.shape[1]), aux_s.dtype)
            aux_p[:n] = aux_s
            return aux_p

        rec["host_pad_secs"], aux_p = best(pad, reps)
        rec["host_fp_secs"], fp_np = best(
            lambda: screened.band_fingerprints_np(aux_p, n_rows, n_bands),
            reps)

        def put():
            d = torch.from_numpy(fp_np).to(dev)
            sync()
            return d

        rec["host_fp_copy_secs"], _ = best(put, reps)
        rec["host_route_secs"] = (rec["host_gather_secs"]
                                  + rec["host_pad_secs"]
                                  + rec["host_fp_secs"]
                                  + rec["host_fp_copy_secs"])
        del aux_s, aux_p

        aux = np.ascontiguousarray(bank.aux, np.uint64).view(np.uint8)

        def aux_upload():
            return screened.upload_sorted_rows(aux, None, 0, n + 1,
                                               dev).view(torch.int64)

        rec["card_upload_secs"], d_aux = best(aux_upload, reps)

        def kernel():
            fp = screened.band_fingerprints(d_aux, d_rows, n_rows, n_bands)
            sync()
            return fp

        rec["card_kernel_secs"], fp = best(kernel, reps)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        screened.band_fingerprints(d_aux, d_rows, n_rows, n_bands)
        end.record()
        sync()
        rec["card_kernel_ms"] = start.elapsed_time(end)
        t0 = time.perf_counter()
        del d_aux
        sync()
        rec["card_free_secs"] = time.perf_counter() - t0
        rec["card_route_secs"] = (rec["card_upload_secs"]
                                  + rec["card_kernel_secs"]
                                  + rec["card_free_secs"])
        rec["bit_equal"] = bool(np.array_equal(fp.cpu().numpy(), fp_np))
        del fp
    else:
        rec["host_aux_gather_secs"], _ = best(lambda: bank.aux[order], reps)

    params = SelectionParams(tau=cell.tau, criterion=cell.criterion)
    walls = []
    for _ in range(reps):
        fresh = SketchBank.from_arrays(
            names=b.names, regs=b.regs, p=b.p, aux=b.aux,
            aux_kind=b.aux_kind, aux_param=b.aux_param)
        t0 = time.perf_counter()
        plan = screened.ScreenPlan(fresh, params, ti, dev)
        wall = time.perf_counter() - t0
        walls.append(dict(plan_secs=wall, upload_secs=plan.upload_secs,
                          cards_secs=plan.cards_secs, fp_secs=plan.fp_secs,
                          rest_secs=wall - plan.upload_secs
                          - plan.cards_secs - plan.fp_secs))
        del plan
        torch.cuda.empty_cache()
    rec["plan"] = min(walls, key=lambda w: w["plan_secs"])
    rec["pack"] = pack_stage(torch, screened.ScreenPlan(fresh, params, ti,
                                                        dev))
    return rec


def pack_stage(torch, plan):
    """The pack stage at the cell's screen launches (module docstring):
    launches, blocks a K1 launch, bytes, bound_ms, and the device ms of
    pack_planes_kernel in a trace of one screen_tiles after a warm one."""
    from cuda_selection_criteria_tpu_torch.ops import screen
    from cuda_selection_criteria_tpu_torch.parallel import screened
    from cuda_selection_criteria_tpu_torch.utils import hopper
    from cuda_selection_criteria_tpu_torch.utils.profiling import (
        device_trace)

    rows, cols = plan.schedule()
    rows, cols = plan.prune_tiles(rows, cols, chunk=256)
    chunk = screened.auto_chunk(plan.ti)
    blocks = []
    real = screen.launch_tiles

    def spy(row_tiles, col_tiles, shared, device):
        blocks.append(len(screen.block_slots(row_tiles, col_tiles,
                                             shared)[0]))
        return real(row_tiles, col_tiles, shared, device)

    screen.launch_tiles = spy
    try:
        plan.screen_tiles(rows, cols, chunk=chunk)
        blocks.clear()
        with device_trace() as prof:
            plan.screen_tiles(rows, cols, chunk=chunk)
            torch.cuda.synchronize()
    finally:
        screen.launch_tiles = real
    pack_us, kernels = 0.0, 0
    for ev in prof.key_averages():
        if "pack_planes_kernel" in ev.key and ev.self_device_time_total:
            pack_us += ev.self_device_time_total
            kernels += ev.count
    ti, r = plan.ti, plan.d_bank.shape[1]
    nbins = len(screen.telescope(plan.bank.p, plan.values)[1])
    k1_bytes = sum(b * ti * (r + nbins * screen.plane_words(plan.bank.p)
                             * 4) for b in blocks)
    k2_bytes = 0
    if plan.coef_aux is not None:
        p_aux = plan.bank.aux_param
        nb_aux = len(screen.telescope(p_aux, plan.values_aux)[1])
        n_pad, r_aux = plan.d_aux_regs.shape
        k2_bytes = len(blocks) * n_pad * (
            r_aux + screen.plane_row_words(p_aux, nb_aux) * 4)
    nbytes = k1_bytes + k2_bytes
    return dict(tiles_live=len(rows), k1_launches=len(blocks),
                k1_blocks=blocks, k2_launches=len(blocks) if k2_bytes
                else 0, k1_bytes=k1_bytes, k2_bytes=k2_bytes,
                bound_ms=nbytes / hopper.HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", pack_kernels=kernels,
                device_ms=pack_us / 1e3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", default=["smh_a-524k",
                                                   "hll_a-16k"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    from benchmark.run import load_cells

    if not torch.cuda.is_available():
        print("plan_split needs a CUDA card", file=sys.stderr)
        return 1
    specs = load_cells()
    ok = True
    for name in args.cells:
        rec = split(torch, specs[name], args.seed, args.reps)
        ok &= rec["bit_equal"]
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
