"""Confirm-stage host parallelism sweep. Port of the JAX package's
experiments/confirm_thread_sweep.py.

The confirm stage's host loop - the fused gather + max + histogram pass of
libfastx (native/fastx.pair_union_hist) feeding the vectorized f64 MLE
(utils/hostref.ertl_mle_batch) - is parallel over pairs on the native
thread pool. This measures pairs/s against the thread count on this host,
holds every thread count's histograms equal to the first's, and writes a
CSV (the reference script's columns). Returns 1 when libfastx is not
available.

    python -m \\
        cuda_selection_criteria_tpu_torch.experiments.confirm_thread_sweep \\
        [--out confirm_threads.csv] [--pairs 100000] [--threads 1 2 4 8]
"""

import argparse
import csv
import os
import sys
import time

import numpy as np

from ..native import fastx
from ..utils import hostmem
from ..utils.hostref import ertl_mle_batch


def sweep(n, n_pairs, p, reps, threads):
    """One CSV row per thread count: the best pairs/s over `reps` of the
    histograms alone and of the histograms plus the MLE, on a uint8 bank of
    n rows with registers 0..11 (about 2k hashes a genome) and n_pairs
    uniform pairs (default_rng(42))."""
    rng = np.random.default_rng(42)
    regs = rng.integers(0, 12, size=(n, 1 << p), dtype=np.uint8)
    ii = rng.integers(0, n, n_pairs).astype(np.int64)
    kk = rng.integers(0, n, n_pairs).astype(np.int64)
    ncpu = os.cpu_count() or 1
    rows, first = [], None
    for t in threads:
        best_hist = best_full = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            h = fastx.pair_union_hist(regs, ii, kk, threads=t)
            dt_hist = time.perf_counter() - t0
            t1 = time.perf_counter()
            est = ertl_mle_batch(h, p)
            dt_mle = time.perf_counter() - t1
            if not np.all(np.isfinite(est)):
                raise RuntimeError("non-finite union cardinality")
            if first is None:
                first = h
            elif not np.array_equal(h, first):
                raise RuntimeError(f"histograms on {t} threads differ from "
                                   f"those on {threads[0]}")
            best_hist = max(best_hist, n_pairs / dt_hist)
            best_full = max(best_full, n_pairs / (dt_hist + dt_mle))
        rows.append({
            "threads": t, "ncpu": ncpu, "pairs": n_pairs,
            "hist_pairs_per_sec": round(best_hist, 1),
            "hist_plus_mle_pairs_per_sec": round(best_full, 1),
        })
        print(rows[-1], flush=True)
    return rows


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="confirm_thread_sweep",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--p", type=int, default=14)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--threads", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--out", default="confirm_threads.csv")
    args = ap.parse_args(argv)

    if not fastx.available():
        print("libfastx unavailable", file=sys.stderr)
        return 1
    rows = sweep(args.n, args.pairs, args.p, args.reps, args.threads)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out} (host has {rows[0]['ncpu']} cpu)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
