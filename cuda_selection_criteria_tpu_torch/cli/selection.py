"""selection CLI - parity with the reference binaries.

Reference usage (README.md:57-66, src/selection.cpp:86-111):
    selection -l <filelist> -t <threads> -a <aux_bytes> -h <tau> -c <criterion>

Loads the persisted sketches, runs the CB + auxiliary-criterion cascade with
exact HLL-union confirmation, and prints `fileA fileB jaccard` lines in the
reference's sorted-row order. Port of cuda_selection_criteria_tpu/cli/
selection.py, for every criterion: smh_a, smh_only (the smh_a band gate
without CB, loading the same .smh files), hll_a, hll_an, cb and baseline,
and every engine: screened, dense, and the multi-device ones over every
CUDA device (--device cuda) or the named device alone: sharded (the
screened cascade with its tiles split over the devices), dense-sharded or
--sharded (the dense rows x regs mesh) and ring (the bank split into strips
that circulate).

Defaults mirror src/selection.cpp:76-82: tau=0.9, aux=256 bytes.
"""

import argparse
import sys

from ..utils import hostmem


def main(argv=None, stats=None):
    """Run the CLI on argv; `stats` (optional dict) receives the engine's
    stage walls and counts (every engine but dense-sharded)."""
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="selection", description=__doc__,
                                 add_help=False)
    ap.add_argument("-x", action="store_true", dest="usage")
    ap.add_argument("--help", action="help")
    ap.add_argument("-l", dest="list_file", default="")
    ap.add_argument("-t", dest="threads", type=int, default=8)
    ap.add_argument("-a", dest="aux_bytes", type=int, default=256)
    ap.add_argument("-h", dest="threshold", type=float, default=0.9)
    ap.add_argument("-c", dest="criterion", default="")
    # -b: block size, flag-parity with selection_cuda
    # (src/selection_cuda.cpp:68-88). None (unset) = the engine's rule:
    # screened parallel.screened.auto_tile, dense 512.
    ap.add_argument("-b", "--block", type=int, default=None, dest="block")
    ap.add_argument("--precision", default="bf16", choices=["bf16", "int8"],
                    help="dense engine's indicator products: bf16 (an f32 "
                         "matmul) or int8 (torch._int_mm); both exact")
    ap.add_argument("--sharded", action="store_true",
                    help="the dense multi-device mesh engine (shorthand for "
                         "--engine dense-sharded)")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "screened", "dense", "sharded",
                             "dense-sharded", "ring"],
                    help="selection engine: auto (screened on CUDA, dense "
                         "on the CPU), screened (the certified screen "
                         "cascade), dense (blockwise exact MLE), sharded "
                         "(the screened cascade, tiles split over the "
                         "devices), dense-sharded (rows x regs mesh), ring "
                         "(bank split into circulating strips)")
    ap.add_argument("--checkpoint", default=None,
                    help="screen sweep progress file: a run that a fault "
                         "ends resumes here instead of recomputing the "
                         "completed spans")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda: for the "
                         "multi-device engines every CUDA device; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.block is not None and args.block <= 0:
        print(f"Option -b invalid: block must be > 0 (got {args.block}).")
        return 0

    if args.usage:
        print("Usage: -l -t -a -h -c")
        return 0

    valid = ("hll_a", "hll_an", "smh_a", "cb", "baseline", "smh_only")
    if args.criterion not in valid:
        print("Option -c invalid. The accepted criteria are hll_a, hll_an and smh_a.")
        return 0

    from ..models import SketchBank
    from ..parallel.mesh import select_pairs_sharded
    from ..parallel.ring import select_pairs_ring
    from ..parallel.screened import (select_pairs_screened,
                                     select_pairs_screened_sharded)
    from ..parallel.selection import (SelectionParams, format_results,
                                      select_pairs)
    from ..utils.filelist import load_file_list
    from ..utils.resilience import run_with_transient_retry

    files = load_file_list(args.list_file)
    load_crit = {"hll_a": "hll_a", "hll_an": "hll_an", "smh_a": "smh_a",
                 "smh_only": "smh_a"}.get(args.criterion)
    # -t: the reference's OpenMP thread count (src/selection.cpp:113-115);
    # here the threads that load the sketch files
    bank = SketchBank.from_sketch_files(files, criterion=load_crit,
                                        aux_bytes=args.aux_bytes,
                                        io_threads=max(1, args.threads))
    params = SelectionParams(
        tau=args.threshold,
        criterion=args.criterion,
        aux_bytes=args.aux_bytes,
        # unset: 512 for the dense engine; the screened engine gets
        # args.block itself and applies its auto rule to None
        block=512 if args.block is None else args.block,
        precision=args.precision,
        engine=args.engine,
    )
    engine = "dense-sharded" if args.sharded else args.engine
    if engine == "dense-sharded":
        def run():
            return select_pairs_sharded(bank, params, device=args.device)
    elif engine == "sharded":
        # -b is the screen tile here (the reference's -b is its CUDA
        # kernel's block size: the same knob, the same default)
        def run():
            return select_pairs_screened_sharded(
                bank, params, ti=args.block or 512, device=args.device,
                stats=stats)
    elif engine == "ring":
        def run():
            return select_pairs_ring(bank, params, device=args.device,
                                     stats=stats)
    elif engine == "screened":
        def run():
            return select_pairs_screened(bank, params, ti=args.block,
                                         device=args.device, stats=stats,
                                         checkpoint=args.checkpoint)
    else:
        def run():
            return select_pairs(bank, params, device=args.device,
                                stats=stats, checkpoint=args.checkpoint)
    results = run_with_transient_retry(run)
    for line in format_results(results):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
