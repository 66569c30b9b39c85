"""Differential harness: the device engine against the scalar host engine
(parity: run_comparison_experiment.sh:57-113). Port of the JAX package's
experiments/compare_engines.py.

Runs select_pairs on the device and the sequential scalar host engine
(utils/hostref.select_pairs_host) on the same sketch files at a low
threshold (the reference compares at tau=0.01 to surface many pairs,
run_comparison_experiment.sh:62-64), joins on the pair key and writes one
`;`-separated row a pair: par, the device similarity, the host similarity,
|delta| and OK / FAIL / MISSING. The reference tolerated 1e-6 between its
CPU and GPU (which used different estimators); both engines here confirm
through the same f64 MLE, so every delta is exactly 0. Exits 1 on any
mismatch.

The host side applies the cardinality bound exactly when the criterion
does (not for baseline and smh_only), as the selection CLI and the device
engines do; the JAX script applies it to every criterion.

    python -m cuda_selection_criteria_tpu_torch.experiments.compare_engines \
        -l list.txt -a 256 -t 0.01 -c hll_a [--device cpu]
"""

import argparse
import csv
import sys
import time

import numpy as np
import torch

from ..utils import hostmem

EPS = 1e-6
NO_CB = ("baseline", "smh_only")


def _key(a, b):
    return (a, b) if a <= b else (b, a)


def load_bank(files, criterion, aux_bytes):
    """The SketchBank the selection CLI loads for `criterion`."""
    from ..models import SketchBank

    load_crit = {"smh_only": "smh_a"}.get(criterion, criterion)
    return SketchBank.from_sketch_files(
        files, criterion=None if load_crit in ("cb", "baseline") else
        load_crit, aux_bytes=aux_bytes)


def run_both(bank, params, device, stats=None):
    """(device pairs, host pairs): select_pairs(bank, params) on `device`
    and the scalar host engine at params.tau and params.criterion, each
    [(name_i, name_j, jacc)]. stats: optional dict, filled with the device
    engine's stats and the walls of both sides, device_secs (ending in the
    engine's last host read) and host_secs."""
    from ..parallel.selection import select_pairs
    from ..utils.hostref import select_pairs_host

    st = {} if stats is None else stats
    t0 = time.perf_counter()
    dev = select_pairs(bank, params, device=device, stats=st)
    t1 = time.perf_counter()
    host = select_pairs_host(bank, params.tau, params.criterion,
                             apply_cb=params.criterion not in NO_CB)
    st.update(device_secs=t1 - t0, host_secs=time.perf_counter() - t1)
    return dev, host


def compare_rows(dev, host, eps=EPS):
    """(rows, mismatches): one row a pair key of either side, in sorted key
    order: [par, sim_device, sim_host, delta, OK|FAIL|MISSING]."""
    dev_map = {_key(a, b): j for a, b, j in dev}
    host_map = {_key(a, b): j for a, b, j in host}
    rows = []
    n_bad = 0
    for k in sorted(set(dev_map) | set(host_map)):
        a = dev_map.get(k)
        b = host_map.get(k)
        if a is None or b is None:
            n_bad += 1
            rows.append(["|".join(k), a, b, "", "MISSING"])
            continue
        d = abs(a - b)
        ok = d <= eps
        n_bad += 0 if ok else 1
        rows.append(["|".join(k), f"{a:.6f}", f"{b:.6f}", f"{d:.2e}",
                     "OK" if ok else "FAIL"])
    return rows, n_bad


def write_rows(path, rows, device):
    """The JAX script's CSV, its device column named for `device`."""
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, delimiter=";")
        w.writerow(["par", f"sim_{torch.device(device).type}", "sim_host",
                    "delta", "ok"])
        w.writerows(rows)


def estimator_deltas(bank, host, device):
    """|J_ORIGINAL - J_MLE| over the host pairs: the deviation the
    reference's own CPU (ERTL-MLE) vs GPU (Flajolet ORIGINAL,
    criteria_sketch_cuda.cuh:30-65) comparison shows at EPS=1e-6
    (run_comparison_experiment.sh:70,101-106; reference bug #4 in
    SURVEY.md). Union histograms and ORIGINAL estimates on `device`."""
    from ..ops import estimators

    name_pos = {n: i for i, n in enumerate(bank.names)}
    ii = np.array([name_pos[a] for a, _, _ in host], np.int64)
    kk = np.array([name_pos[b] for _, b, _ in host], np.int64)
    merged = torch.from_numpy(np.maximum(bank.regs[ii], bank.regs[kk])).to(
        device)
    counts = estimators.hll_histogram(merged, bank.p)
    t_orig = estimators.original_estimate(counts, bank.p).cpu().numpy()
    e = np.trunc(bank.cards)
    j_orig = (e[ii] + e[kk] - t_orig) / t_orig
    return np.abs(j_orig - np.array([j for _, _, j in host]))


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="compare_engines", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("-l", dest="list_file", required=True)
    ap.add_argument("-a", dest="aux_bytes", type=int, default=32)
    ap.add_argument("-t", dest="tau", type=float, default=0.01)
    ap.add_argument("-c", dest="criterion", default="smh_a")
    ap.add_argument("-o", dest="out", default=None,
                    help="CSV path (default comparacion_<device>_host.csv)")
    ap.add_argument("--estimator-delta", action="store_true",
                    help="also report the ORIGINAL-vs-MLE similarity delta "
                         "over the emitted pairs: the deviation the "
                         "reference's own CPU (MLE) vs GPU (ORIGINAL) pair "
                         "shows at EPS=1e-6")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device engine (default cuda; "
                         "cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from ..parallel.selection import SelectionParams
    from ..utils.filelist import load_file_list

    out = args.out or f"comparacion_{torch.device(args.device).type}_host.csv"
    bank = load_bank(load_file_list(args.list_file), args.criterion,
                     args.aux_bytes)
    dev, host = run_both(bank, SelectionParams(
        tau=args.tau, criterion=args.criterion, aux_bytes=args.aux_bytes),
        args.device)
    rows, n_bad = compare_rows(dev, host)
    write_rows(out, rows, args.device)
    print(f"pairs={len(rows)} mismatches={n_bad} -> {out}")
    if args.estimator_delta and host:
        deltas = estimator_deltas(bank, host, args.device)
        print(f"estimator-delta (ORIGINAL vs MLE similarity, "
              f"{len(deltas)} pairs): max={deltas.max():.3e} "
              f"mean={deltas.mean():.3e} "
              f"over_ref_eps={(deltas > EPS).sum()}/{len(deltas)}")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
