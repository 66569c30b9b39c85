"""Differential validation of the screened engine on a planted-cluster
bank. Port of the JAX package's experiments/validate_screened_tpu.py.

Builds a bank with planted clusters of near-duplicates (known structure)
through the device build ops (ops/hll_build, ops/smh_build), runs
select_pairs_screened, and compares the emitted pairs and Jaccard values
with the scalar host reference (utils/hostref.select_pairs_host): the
at-scale form of the reference's CPU-vs-GPU comparison
(run_comparison_experiment.sh:93-110), with exact equality (Jaccards to 12
digits) in place of its EPS=1e-6. Exits 1 on a mismatch, printing the
missing and extra pairs.

    python -m \\
        cuda_selection_criteria_tpu_torch.experiments.validate_screened \\
        [-n 1024] [--tau 0.8] [--criterion smh_a] [--device cpu]
"""

import argparse
import sys
import time

import numpy as np
import torch

from ..models import SketchBank
from ..ops import hll_build, smh_build
from ..parallel.screened import select_pairs_screened
from ..parallel.selection import SelectionParams
from ..utils import hostmem
from ..utils.device import u64_numpy
from ..utils.hostref import select_pairs_host

BUILD_BATCH = 256  # genomes a build call


def planted_genomes(n, items, n_clusters, mutate, rng):
    """n hash sets of `items` uint64 values: n_clusters clusters of 2 to 4
    copies of a base set, each with int(mutate * items) values redrawn,
    then unrelated sets; the reference scripts' draws, in their order."""
    genomes = []
    for _ in range(n_clusters):
        base = rng.integers(0, 1 << 63, size=items, dtype=np.uint64)
        for _ in range(int(rng.integers(2, 5))):
            g = base.copy()
            idx = rng.choice(items, size=int(mutate * items), replace=False)
            g[idx] = rng.integers(0, 1 << 63, size=idx.size, dtype=np.uint64)
            genomes.append(g)
    while len(genomes) < n:
        genomes.append(rng.integers(0, 1 << 63, size=items, dtype=np.uint64))
    return genomes[:n]


def build_sketches(genomes, build):
    """numpy concatenation of build(kmers, valid, genome_ids, n_genomes)
    over batches of BUILD_BATCH genomes of one length."""
    out = []
    for b0 in range(0, len(genomes), BUILD_BATCH):
        chunk = genomes[b0:b0 + BUILD_BATCH]
        kms = np.concatenate(chunk)
        gids = np.repeat(np.arange(len(chunk), dtype=np.int32), len(chunk[0]))
        out.append(build(kms, np.ones(kms.shape, bool), gids, len(chunk)))
    return np.concatenate(out)


def build_planted_bank(n, p=14, m=32, items=4096, n_clusters=24,
                       mutate=0.05, seed=0, device=None):
    """SketchBank of planted_genomes (default_rng(seed)) with p-precision
    HLL registers and m SMH buckets, built on `device` 256 genomes at a
    time: bit-equal to the reference script's build_planted_bank."""
    genomes = planted_genomes(n, items, n_clusters, mutate,
                              np.random.default_rng(seed))
    regs = build_sketches(genomes, lambda k, v, g, count: hll_build.
                          hll_build_batch(k, v, g, p, count, device).cpu()
                          .numpy())
    aux = build_sketches(genomes, lambda k, v, g, count: u64_numpy(
        smh_build.smh_build_batch(k, v, g, m, count, device)))
    return SketchBank(names=[f"g{i:05d}" for i in range(n)], regs=regs, p=p,
                      aux_kind="smh", aux=aux, aux_param=m)


def rounded(pairs):
    return [(a, b, round(j, 12)) for a, b, j in pairs]


def differential(bank, params, device=None):
    """(ok, screened pairs, host pairs, screened seconds, host seconds):
    select_pairs_screened on `device` against select_pairs_host."""
    t0 = time.perf_counter()
    got = select_pairs_screened(bank, params, device=device)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = select_pairs_host(bank, params.tau, params.criterion)
    t_host = time.perf_counter() - t0
    return rounded(got) == rounded(want), got, want, t_dev, t_host


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="validate_screened",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("-n", type=int, default=1024)
    ap.add_argument("--tau", type=float, default=0.8)
    ap.add_argument("--criterion", default="smh_a")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    print(f"building planted bank n={args.n} ...", flush=True)
    bank = build_planted_bank(args.n, device=args.device)
    params = SelectionParams(tau=args.tau, criterion=args.criterion)
    ok, got, want, t_dev, t_host = differential(bank, params, args.device)
    pairs = args.n * (args.n - 1) // 2
    print(f"screened engine ({torch.device(args.device)}): {len(got)} pairs "
          f"in {t_dev:.2f} s ({pairs / t_dev / 1e6:.1f} Mpairs/s with the "
          "plan's overheads)")
    print(f"host reference: {len(want)} pairs in {t_host:.2f} s")
    if ok:
        print(f"EXACT MATCH: {len(got)} pairs")
        return 0
    sw, sg = {(a, b) for a, b, _ in want}, {(a, b) for a, b, _ in got}
    print(f"MISMATCH: missing={len(sw - sg)} extra={len(sg - sw)}")
    for pair in sorted(sw - sg)[:5]:
        print("  missing:", pair)
    for pair in sorted(sg - sw)[:5]:
        print("  extra:", pair)
    return 1


if __name__ == "__main__":
    sys.exit(main())
