"""build_sketch CLI - parity with the reference binary.

Reference usage (README.md:45-55, src/build_sketch.cpp:198-216):
    build_sketch -l <filelist> -t <threads> -a <aux_bytes> -c {hll_a,hll_an,smh_a}

Builds the primary p=14 HLL sketch for every FASTA/FASTQ in the list plus
the criterion's auxiliary sketch, and persists them next to the input files
in the reference's gz formats (.hll, .hll_{p}, .smh{m}), byte-identical to
the JAX package's cli/build_sketch.py.

-a semantics match the reference: aux BYTES; p_aux = ctz(bytes) for hll_a /
hll_an, m = bytes/8 buckets for smh_a (src/build_sketch.cpp:242,258,274).
-t sets the host threads: the FASTA decode threads of the device pipeline
(the native reader; the pure-Python one, used where the native library does
not build, decodes on one), or the build threads of --backend native.
--backend native builds the sketches on the host with the native
single-pass builder; device and auto run the torch pipeline on --device
(default cuda; cpu runs the same torch ops on the host).
"""

import argparse
import sys

from ..utils import hostmem


def main(argv=None, stats=None):
    """Run the CLI on argv; `stats` (optional dict) receives the build's
    stage seconds and counts (models/bank.build_bank_from_files)."""
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="build_sketch", description=__doc__)
    ap.add_argument("-l", dest="list_file", required=True, help="file list")
    ap.add_argument("-t", dest="threads", type=int, default=8)
    ap.add_argument("-a", dest="aux_bytes", type=int, default=256)
    ap.add_argument("-c", dest="criterion", default="")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "device", "native"],
                    help="sketch builder: device (the torch pipeline on "
                         "--device; auto resolves to it) or native (the C++ "
                         "single-pass builder on -t host threads)")
    ap.add_argument("--bank", dest="bank_out", default=None,
                    help="also save a stacked .npz sketch bank")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sketch builds (default cuda; "
                         "cpu runs the same torch ops on the host)")
    args = ap.parse_args(argv)

    if args.criterion not in ("hll_a", "hll_an", "smh_a"):
        print("Option -c invalid. The accepted criteria are hll_a, hll_an and smh_a.")
        return 0

    from ..models.bank import build_bank_from_files
    from ..utils import formats
    from ..utils.filelist import load_file_list

    files = load_file_list(args.list_file)
    bank = build_bank_from_files(
        files, criterion=args.criterion, aux_bytes=args.aux_bytes,
        io_threads=max(1, args.threads), backend=args.backend,
        device=args.device, stats=stats)
    bank.write_sketch_files()
    if args.bank_out:
        formats.save_bank(
            args.bank_out, bank.names, bank.regs, cards=bank.cards,
            aux=bank.aux, aux_kind=bank.aux_kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
