"""Differential validation of the hll_a / hll_an screened engine (K1 and the
aux-union gate's K2) on a planted-cluster bank with aux HLL sketches. Port
of the JAX package's experiments/validate_hllaux_tpu.py, the twin of
validate_screened.

Builds n genomes of 4096 hashes (24 planted clusters, 4% of each copy's
hashes redrawn; default_rng(11)) into p=14 registers and p_aux=8 aux
registers, runs select_pairs_screened for hll_a and hll_an at tau 0.8 and
raises unless each equals the scalar host reference exactly (Jaccards to 12
digits).

    python -m \\
        cuda_selection_criteria_tpu_torch.experiments.validate_hllaux \\
        [-n 1024] [--device cpu]
"""

import argparse
import sys

import numpy as np

from ..models import SketchBank
from ..ops import hll_build
from ..parallel.selection import SelectionParams
from ..utils import hostmem
from .validate_screened import build_sketches, differential, planted_genomes

SEED = 11
ITEMS = 4096
P, P_AUX = 14, 8
TAU = 0.8


def build_hll_bank(n, device=None):
    """SketchBank of the reference script's planted genomes with HLL aux
    registers at P_AUX, built on `device`."""
    genomes = planted_genomes(n, ITEMS, 24, 0.04,
                              np.random.default_rng(SEED))

    def hll(p):
        return build_sketches(genomes, lambda k, v, g, count: hll_build.
                              hll_build_batch(k, v, g, p, count, device).cpu()
                              .numpy())

    return SketchBank(names=[f"g{i:05d}" for i in range(n)], p=P,
                      regs=hll(P), aux_kind="hll", aux=hll(P_AUX),
                      aux_param=P_AUX)


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="validate_hllaux", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("-n", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    bank = build_hll_bank(args.n, args.device)
    for crit in ("hll_a", "hll_an"):
        ok, got, want, t_dev, _ = differential(
            bank, SelectionParams(tau=TAU, criterion=crit), args.device)
        print(f"{crit}: screened={len(got)} host={len(want)} match={ok} "
              f"({t_dev:.1f} s)", flush=True)
        if not ok:
            raise RuntimeError(f"{crit}: the screened engine's pairs differ "
                               "from the host reference's")
    print("HLL-AUX SCALE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
