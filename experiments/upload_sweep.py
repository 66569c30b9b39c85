#!/usr/bin/env python3
"""The sorted bank upload of the torch port on one card: the
slab-pipelined upload_sorted_rows (parallel/screened.py) with 1, 2, 4 and
8 host threads sharing each slab's gather, beside the whole-bank path it
replaced (one pageable upload of the raw bank, then a gather on the card),
on a random uint8 bank of N rows of 16 KiB (p=14) in a random order.

    python3 experiments/upload_sweep.py [--n 131072 524288] [--reps 2]

One JSON line a (N, path): the best wall of --reps runs (each ending in a
synchronize), upload_sorted_rows's stats of that run, and the card's peak
allocated bytes above what it held before, beside the card's name and
power limit. Needs one CUDA card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cuda_selection_criteria_tpu_torch.parallel.screened import (  # noqa
    upload_sorted_rows)
from cuda_selection_criteria_tpu_torch.utils import hopper  # noqa: E402


def whole_bank(regs, order, dev):
    """The path upload_sorted_rows replaced: the raw bank uploaded from
    pageable memory, then gathered into a zero-padded copy on the card
    (three copies at its peak)."""
    out = torch.zeros(regs.shape, dtype=torch.uint8, device=dev)
    raw = torch.from_numpy(regs).to(dev)
    out[:len(order)] = raw[torch.from_numpy(order).to(dev)]
    torch.cuda.synchronize(dev)
    return out


def timed(fn, reps, dev):
    """(best seconds, stats of that run, peak bytes above the start)."""
    best = (float("inf"), None, None)
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        stats = {}
        t0 = time.perf_counter()
        out = fn(stats)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - held
        del out
        if secs < best[0]:
            best = (secs, stats, peak)
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, nargs="+", default=[131072, 524288])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = hopper.card_line()
    rng = np.random.default_rng(0x5A1B)
    for n in args.n:
        regs = np.empty((n, 1 << 14), np.uint8)
        for r0 in range(0, n, 8192):
            regs[r0:r0 + 8192] = rng.integers(0, 32, (min(8192, n - r0),
                                                      1 << 14), np.uint8)
        order = rng.permutation(n)
        paths = {f"upload_sorted_rows threads={t}": (
            lambda st, t=t: upload_sorted_rows(regs, order, 0, n, dev,
                                               stats=st, threads=t))
            for t in (1, 2, 4, 8)}
        paths["whole bank (raw upload, gather on the card)"] = (
            lambda st: whole_bank(regs, order, dev))
        for name, fn in paths.items():
            secs, stats, peak = timed(fn, args.reps, dev)
            print(json.dumps({"n": n, "bank_bytes": regs.nbytes,
                              "path": name, "secs": secs,
                              "gib_per_s": regs.nbytes / secs / 2**30,
                              "peak_bytes": peak, "stats": stats,
                              "card": card}), flush=True)
        del regs
    return 0


if __name__ == "__main__":
    sys.exit(main())
