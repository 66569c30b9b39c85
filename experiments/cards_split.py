#!/usr/bin/env python3
"""The split of the torch port's host cardinalities (models/bank.host_cards)
on a bank of N rows at p=14: the native row histograms (fastx.row_hist)
on 1 thread and on min(8, cores), optionally the numpy row histograms
they replaced, then the ERTL-MLE in one ertl_mle_batch call and over row
chunks on threads (bank.mle_rows), and host_cards as a whole.

    python3 experiments/cards_split.py [--n 16384 524288] [--reps 3] [--plain]
    python3 experiments/cards_split.py --cells hll_a-16k smh_a-524k [--seed 0]

The bank is the reference bench's draw (2048 hashes a genome,
utils/synth.synthetic_regs) for 16,384 rows, tiled to N. One JSON line an
N: the best wall of --reps runs of each step, with the host's core count
and, where nvidia-smi answers, the card's name and power limit (the
machine the run was on; no step uses the card). Exits 1 unless every
route gives the same histograms and the same cards bit for bit.

With --cells, the split of the screened plan's cards on the card instead,
for each named benchmark cell's bank (benchmark/bank.py from --seed, as
python3 -m benchmark.run makes it): the bank uploaded once (not timed),
the row histograms (screen.row_hist, CUDA events), then both routes from
those histograms, best of --reps, host clock ending in the host array:
the host route (the histograms' copy to the host, then bank.mle_rows)
and the card route (bank.cards_from_hists: the MLE kernel, the copy of
its estimates and flags, the host rows), with the MLE kernel alone
(CUDA events) and the number of host rows. Needs a card; exits 1 unless
both routes give the same cards bit for bit.
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

from cuda_selection_criteria_tpu_torch.models import bank  # noqa: E402
from cuda_selection_criteria_tpu_torch.native import fastx  # noqa: E402
from cuda_selection_criteria_tpu_torch.utils import hostref  # noqa: E402
from cuda_selection_criteria_tpu_torch.utils import synth  # noqa: E402


def best(fn, reps):
    """(best seconds of reps runs, the last result)."""
    secs = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        secs = min(secs, time.perf_counter() - t0)
    return secs, out


def card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def cuda_best_ms(torch, fn, reps):
    """Best milliseconds of reps calls of fn on the card (CUDA events),
    after one warm-up call."""
    fn()
    ms = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms = min(ms, start.elapsed_time(end))
    return ms


def card_split(cells, seed, reps):
    """The --cells mode: one JSON line a cell; True when both routes gave
    the same cards."""
    import torch

    from benchmark import bank as bank_mod
    from benchmark.run import load_cells
    from cuda_selection_criteria_tpu_torch.ops import estimators, screen

    if not torch.cuda.is_available():
        print("cards_split --cells needs a CUDA card", file=sys.stderr)
        return False
    specs = load_cells()
    ok = True
    for name in cells:
        cell = specs[name]
        t0 = time.perf_counter()
        regs = bank_mod.make_bank(cell.n, cell.aux_kind, cell.aux_param,
                                  cell.planted, seed).regs
        rec = {"cell": name, "seed": seed, "n": len(regs), "p": 14,
               "bank_secs": time.perf_counter() - t0,
               "threads": min(8, os.cpu_count() or 1),
               "cores": os.cpu_count(), "card": card()}
        d = torch.from_numpy(regs).to("cuda")
        torch.cuda.synchronize()
        rec["row_hist_ms"] = cuda_best_ms(torch, lambda: screen.row_hist(d),
                                          reps)
        hists, _ = screen.row_hist(d)
        rec["mle_kernel_ms"] = cuda_best_ms(
            torch, lambda: estimators.ertl_mle(hists, 14, branch=True), reps)
        rec["host_route_secs"], host = best(
            lambda: bank.mle_rows(hists.cpu().numpy(), 14), reps)
        rec["hists_copy_secs"], _ = best(lambda: hists.cpu().numpy(), reps)
        (rec["card_route_secs"],
         (cards, rec["host_rows"])) = best(
            lambda: bank.cards_from_hists(hists, 14), reps)
        rec["bit_equal"] = bool(np.array_equal(cards.view(np.int64),
                                               host.view(np.int64)))
        ok &= rec["bit_equal"]
        print(json.dumps(rec), flush=True)
        del d, hists
        torch.cuda.empty_cache()
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[16384, 524288])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--plain", action="store_true",
                    help="also time the numpy row histograms (one thread)")
    ap.add_argument("--cells", nargs="+", default=None,
                    help="the card split of these benchmark cells' banks")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cells:
        return 0 if card_split(args.cells, args.seed, args.reps) else 1
    if not fastx.available():
        print(f"libfastx unavailable: {fastx.info()['error']}",
              file=sys.stderr)
        return 1
    base = synth.synthetic_regs(16384, 2048, 14, np.random.default_rng(0))
    threads = min(8, os.cpu_count() or 1)
    ok = True
    for n in args.n:
        regs = np.tile(base, (-(-n // len(base)), 1))[:n]
        rec = {"n": n, "p": 14, "threads": threads,
               "cores": os.cpu_count(), "card": card()}
        rec["hist_1_thread_secs"], h1 = best(
            lambda: fastx.row_hist(regs, 1), args.reps)
        rec["hist_secs"], hists = best(lambda: fastx.row_hist(regs),
                                       args.reps)
        ok &= np.array_equal(h1, hists)
        if args.plain:
            rec["hist_numpy_secs"], hn = best(
                lambda: bank._row_hists_numpy(regs), 1)
            ok &= np.array_equal(hn, hists)
        rec["mle_one_call_secs"], one = best(
            lambda: hostref.ertl_mle_batch(hists, 14), args.reps)
        rec["mle_chunked_secs"], chunked = best(
            lambda: bank.mle_rows(hists, 14), args.reps)
        rec["host_cards_secs"], cards = best(
            lambda: bank.host_cards(regs, 14), args.reps)
        ok &= (np.array_equal(one.view(np.int64), chunked.view(np.int64))
               and np.array_equal(one.view(np.int64), cards.view(np.int64)))
        rec["bit_equal"] = bool(ok)
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
