"""time_smh CLI - criterion-timing experiment, CSV-row parity. Port of
cuda_selection_criteria_tpu/cli/time_smh.py.

Reference protocol (experiments/src/time_smh.cpp:124-295): load prebuilt
.hll files, build SuperMinHash sketches in memory (NB: -m is a bucket COUNT
here, unlike -a aux BYTES in build_sketch/selection - the reference's units
trap, time_smh.cpp:156), then time two selection sweeps:

  smh_a     - the banding criterion + union confirm over the FULL triangle
  CB+smh_a  - the same with the cardinality bound + row truncation

emitting semicolon CSV rows consumed by run_time_experiment.sh:24-26:

  {list};build_smh;{tau};{seconds};m:{m}
  {list};smh_a;{tau};{seconds};r:{rows}_b:{bands}
  {list};CB+smh_a;{tau};{seconds};r:{rows}_b:{bands}

then two kernel-sweep rows, smh_a_kernel and CB+smh_a_kernel, with the
same fields: the device screen alone over the schedule. Timings end in a
device synchronisation - unlike the reference GPU harness, which timed
only the kernel launch (time_smh_cuda.cpp:279-283). --device picks the
torch device (default cuda; cpu runs the kernels' plain versions).
"""

import argparse
import sys
import time
from dataclasses import replace

from ..utils import hostmem


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="time_smh", description=__doc__,
                                 add_help=False)
    ap.add_argument("-x", action="store_true", dest="usage")
    ap.add_argument("--help", action="help")
    ap.add_argument("-l", dest="list_file", required=True)
    ap.add_argument("-t", dest="threads", type=int, default=8)
    ap.add_argument("-h", dest="threshold", type=float, default=0.9)
    ap.add_argument("-m", dest="mh_size", type=int, default=512,
                    help="SuperMinHash bucket COUNT (not bytes)")
    ap.add_argument("-R", dest="reps", type=int, default=1)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.usage:
        print("Usage: -l -t -h -m")
        return 0

    import numpy as np

    from ..models.bank import (PRIMARY_P, SketchBank, build_bank_from_files,
                               load_hll_bank)
    from ..ops import criteria
    from ..parallel.screened import ScreenPlan
    from ..parallel.selection import SelectionParams, select_pairs
    from ..utils.filelist import load_file_list

    files = load_file_list(args.list_file)
    tau = args.threshold
    m = args.mh_size
    dev = args.device

    # --- build: SMH in memory (device), primary .hll from disk ---
    t0 = time.perf_counter()
    threads = max(1, args.threads)
    smh_bank = build_bank_from_files(files, criterion="smh_a",
                                     aux_bytes=8 * m, io_threads=threads,
                                     device=dev)
    bank = SketchBank(
        names=list(files),
        regs=load_hll_bank([f + ".hll" for f in files], PRIMARY_P, threads),
        aux_kind="smh", aux=smh_bank.aux, aux_param=m)
    _sync(dev)
    build_secs = time.perf_counter() - t0
    print(f"{args.list_file};build_smh;{tau:g};{build_secs};m:{m}")

    n_rows, n_bands = criteria.smh_band_params(m, tau)
    params = SelectionParams(tau=tau, criterion="smh_a", aux_bytes=8 * m,
                             block=args.block)
    for _ in range(args.reps):
        # --- sweep 1: smh_a only (full triangle, no CB; the reference's
        # smh_a-only sweep, time_smh.cpp:228-257) ---
        t0 = time.perf_counter()
        select_pairs(bank, replace(params, criterion="smh_only"), device=dev)
        secs = time.perf_counter() - t0
        print(f"{args.list_file};smh_a;{tau:g};{secs};r:{n_rows}_b:{n_bands}")

        # --- sweep 2: CB + smh_a ---
        t0 = time.perf_counter()
        select_pairs(bank, params, device=dev)
        secs = time.perf_counter() - t0
        print(f"{args.list_file};CB+smh_a;{tau:g};{secs};r:{n_rows}_b:{n_bands}")

    # --- kernel-sweep rows: the device screen ONLY (bank resident on the
    # device, schedule precomputed, host confirmation excluded) - the
    # reference's H2D-once kernel-timing protocol
    # (experiments/src/time_smh_cuda.cpp:181-307), with one device sync
    # per sweep. One untimed warm-up sweep; the tile order is permuted per
    # rep so no result cache can serve a repeat. Launches take `chunk`
    # tiles, the last one the remainder (the JAX package pads it to a
    # full chunk to keep one compiled shape).
    chunk = 64
    for label, crit in (("smh_a_kernel", "smh_only"),
                        ("CB+smh_a_kernel", "smh_a")):
        plan = ScreenPlan(bank, replace(params, criterion=crit), ti=512,
                          device=dev)
        rows, cols = plan.schedule()
        if not len(rows):
            continue

        def sweep(seed):
            perm = np.random.default_rng(seed).permutation(len(rows))
            r, c = rows[perm], cols[perm]
            for c0 in range(0, len(r), chunk):
                plan.screen_chunk(r[c0:c0 + chunk], c[c0:c0 + chunk])
            _sync(plan.device)

        sweep(0)  # warm-up
        for rep in range(args.reps):
            t0 = time.perf_counter()
            sweep(rep + 1)
            secs = time.perf_counter() - t0
            print(f"{args.list_file};{label};{tau:g};{secs};"
                  f"r:{n_rows}_b:{n_bands}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
