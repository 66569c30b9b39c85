"""Timing-experiment orchestration (parity: run_time_experiment.sh). Port of
the JAX package's experiments/run_time_experiment.py.

Sweeps SuperMinHash sizes and block sizes over the time_smh CLI and writes
experimento_smh_comparativo.csv with rows `impl,block,mh_size,rep,
criterio,tiempo` (the columns of run_time_experiment.sh:15-16). Like the
reference's script, which sweeps both its CPU binary (time_smh) and its GPU
binary (time_smh_cuda) into one CSV (run_time_experiment.sh:19-42), it has
two arms:

  cuda      - the time_smh CLI on the card (device build and device-screened
              sweeps); `cpu-torch` when --device cpu runs the plain versions
  host      - the all-host twin: the native C++ single-pass sketch builder
              (native/fastx.cpp, threaded like the reference's OpenMP loop)
              and the sequential scalar selection
              (utils/hostref.select_pairs_host, the reference's CPU control
              flow), block 0

The reference's defaults are m=512, block=256 and one repetition
(run_time_experiment.sh:4-10).

    python -m \
        cuda_selection_criteria_tpu_torch.experiments.run_time_experiment \
        -l list.txt --mh-sizes 64 512 --blocks 256 512 [--device cpu]
"""

import argparse
import csv
import io
import sys
import time
from contextlib import redirect_stdout

import torch

from ..utils import hostmem

HEADER = ["impl", "block", "mh_size", "rep", "criterio", "tiempo"]


def device_label(device):
    """The device arm's impl label: "cuda" only when it ran on a card."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu-torch"


def device_arm_rows(list_file, threshold, mh_sizes, blocks, reps, device):
    """Rows of the device arm: time_smh -h -m --block --device, one call a
    (block, m, rep), each of its CSV lines a row."""
    from ..cli import time_smh

    impl = device_label(device)
    rows = []
    for block in blocks:
        for m in mh_sizes:
            for rep in range(1, reps + 1):
                buf = io.StringIO()
                with redirect_stdout(buf):
                    rc = time_smh.main([
                        "-l", list_file, "-h", str(threshold), "-m", str(m),
                        "--block", str(block), "--device", str(device)])
                if rc:
                    raise RuntimeError(f"time_smh exited {rc}")
                for line in buf.getvalue().splitlines():
                    parts = line.split(";")
                    if len(parts) >= 4:
                        rows.append([impl, block, m, rep, parts[1],
                                     parts[3]])
    return rows


def host_arm_rows(files, threshold, mh_sizes, reps):
    """impl="host" rows: the native C++ sketch build and the sequential
    scalar selection without and with CB, with the device arm's row schema
    (the reference's CPU binary arm, run_time_experiment.sh:19-27)."""
    from ..models.bank import (PRIMARY_P, SketchBank, build_bank_from_files,
                               load_hll_bank)
    from ..utils.hostref import select_pairs_host

    rows = []
    for m in mh_sizes:
        for rep in range(1, reps + 1):
            t0 = time.perf_counter()
            smh_bank = build_bank_from_files(
                files, criterion="smh_a", aux_bytes=8 * m, backend="native")
            bank = SketchBank(
                names=list(files),
                regs=load_hll_bank([f + ".hll" for f in files], PRIMARY_P),
                aux_kind="smh", aux=smh_bank.aux, aux_param=m)
            rows.append(["host", 0, m, rep, "build_smh",
                         time.perf_counter() - t0])

            t0 = time.perf_counter()
            select_pairs_host(bank, threshold, "smh_a", apply_cb=False)
            rows.append(["host", 0, m, rep, "smh_a",
                         time.perf_counter() - t0])

            t0 = time.perf_counter()
            select_pairs_host(bank, threshold, "smh_a", apply_cb=True)
            rows.append(["host", 0, m, rep, "CB+smh_a",
                         time.perf_counter() - t0])
    return rows


def write_csv(path, rows):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(HEADER)
        w.writerows(rows)


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="run_time_experiment",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("-l", dest="list_file", required=True)
    ap.add_argument("--threshold", type=float, default=0.9)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--mh-sizes", type=int, nargs="+", default=[512])
    ap.add_argument("--blocks", type=int, nargs="+", default=[512])
    ap.add_argument("-o", dest="out",
                    default="experimento_smh_comparativo.csv")
    ap.add_argument("--no-host", action="store_true",
                    help="skip the host arm (device rows only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device arm (default cuda; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from ..utils.filelist import load_file_list

    rows = []
    if not args.no_host:
        rows += host_arm_rows(load_file_list(args.list_file), args.threshold,
                              args.mh_sizes, args.reps)
    rows += device_arm_rows(args.list_file, args.threshold, args.mh_sizes,
                            args.blocks, args.reps, args.device)
    write_csv(args.out, rows)
    print(f"Listo, resultados en {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
