"""selection CLI - parity with the reference binaries.

Reference usage (README.md:57-66, src/selection.cpp:86-111):
    selection -l <filelist> -t <threads> -a <aux_bytes> -h <tau> -c <criterion>

Loads the persisted sketches, runs the CB + auxiliary-criterion cascade with
exact HLL-union confirmation, and prints `fileA fileB jaccard` lines in the
reference's sorted-row order. Port of cuda_selection_criteria_tpu/cli/
selection.py: criteria smh_a, cb and baseline; hll_a, hll_an and smh_only
are later slices (ROADMAP.md queue 1).

Defaults mirror src/selection.cpp:76-82: tau=0.9, aux=256 bytes.
"""

import argparse
import sys

NOT_PORTED = {
    "hll_a": "ROADMAP.md queue 1, item 6 (hll-aux gate)",
    "hll_an": "ROADMAP.md queue 1, item 6 (hll-aux gate)",
    "smh_only": "ROADMAP.md queue 1, item 8 (time_smh)",
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="selection", description=__doc__,
                                 add_help=False)
    ap.add_argument("-x", action="store_true", dest="usage")
    ap.add_argument("--help", action="help")
    ap.add_argument("-l", dest="list_file", default="")
    ap.add_argument("-t", dest="threads", type=int, default=8)
    ap.add_argument("-a", dest="aux_bytes", type=int, default=256)
    ap.add_argument("-h", dest="threshold", type=float, default=0.9)
    ap.add_argument("-c", dest="criterion", default="")
    # -b: screen tile size (flag-parity with selection_cuda,
    # src/selection_cuda.cpp:68-88); None = parallel.screened.auto_tile.
    ap.add_argument("-b", "--block", type=int, default=None, dest="block")
    ap.add_argument("--engine", default="auto", choices=["auto", "screened"],
                    help="selection engine: auto or screened (both the "
                         "screened cascade)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
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
    if args.criterion in NOT_PORTED:
        raise NotImplementedError(
            f"-c {args.criterion} is not ported to the torch package yet: "
            f"{NOT_PORTED[args.criterion]}")

    from ..models import SketchBank
    from ..parallel.screened import select_pairs_screened
    from ..parallel.selection import (SelectionParams, format_results,
                                      select_pairs)
    from ..utils.filelist import load_file_list

    files = load_file_list(args.list_file)
    # -t is accepted for flag parity; the numpy loader reads on one thread
    bank = SketchBank.from_sketch_files(
        files, criterion="smh_a" if args.criterion == "smh_a" else None,
        aux_bytes=args.aux_bytes)
    params = SelectionParams(
        tau=args.threshold,
        criterion=args.criterion,
        aux_bytes=args.aux_bytes,
        block=512 if args.block is None else args.block,
        engine=args.engine,
    )
    if args.engine == "screened":
        results = select_pairs_screened(bank, params, ti=args.block,
                                        device=args.device)
    else:
        results = select_pairs(bank, params, device=args.device)
    for line in format_results(results):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
