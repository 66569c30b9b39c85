#!/usr/bin/env python3
"""The split of the torch port's host cardinalities (models/bank.host_cards)
on a bank of N rows at p=14: the native row histograms (fastx.row_hist)
on 1 thread and on min(8, cores), optionally the numpy row histograms
they replaced, then the ERTL-MLE in one ertl_mle_batch call and over row
chunks on threads (bank.mle_rows), and host_cards as a whole.

    python3 experiments/cards_split.py [--n 16384 524288] [--reps 3] [--plain]

The bank is the reference bench's draw (2048 hashes a genome,
utils/synth.synthetic_regs) for 16,384 rows, tiled to N. One JSON line an
N: the best wall of --reps runs of each step, with the host's core count
and, where nvidia-smi answers, the card's name and power limit (the
machine the run was on; no step uses the card). Exits 1 unless every
route gives the same histograms and the same cards bit for bit.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[16384, 524288])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--plain", action="store_true",
                    help="also time the numpy row histograms (one thread)")
    args = ap.parse_args(argv)
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
