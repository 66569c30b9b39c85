"""Throughput against bank size of the screened all-pairs path: the
bench's protocol (experiments/bench.measure) at several N, one JSON row
each. Port of the JAX package's experiments/scale_sweep.py.

    python -m cuda_selection_criteria_tpu_torch.experiments.scale_sweep \\
        [--sizes 4096 8192 16384 24576] [--reps 3] [--ti 1024] \\
        [--device cpu]

vs_baseline divides by the card's own baseline (bench's), measured once
a process; with --device cpu it and tc_util are null.
"""

import argparse
import json
import sys

from ..utils import hopper, hostmem
from ..utils.device import resolve
from . import bench


def rows(sizes, reps=3, ti=bench.TI, device=None):
    """One record a size: n_genomes, pairs_per_sec, vs_baseline,
    raw_kernel_pairs_per_sec, tc_util."""
    dev = resolve(device)
    baseline = hopper.card_baseline(dev)
    for n in sizes:
        headline, raw, util = bench.measure(n, reps, ti=ti, device=dev)
        yield {"n_genomes": n, "pairs_per_sec": headline,
               "vs_baseline": hopper.ratio(headline, baseline),
               "raw_kernel_pairs_per_sec": raw, "tc_util": util}


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="scale_sweep", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[4096, 8192, 16384, 24576])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ti", type=int, default=bench.TI)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    for row in rows(args.sizes, args.reps, args.ti, args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
