"""Raw screen-kernel tuning sweep: K2 (ops/screen.screen_s_z, the two-pass
S(+Z) kernel) alone on the resident bench bank across tile sizes and
launch widths, one JSON line a configuration. Port of the JAX package's
experiments/kernel_tuning.py.

    python -m cuda_selection_criteria_tpu_torch.experiments.kernel_tuning \\
        [--n 16384] [--reps 3] [--tiles 256] \\
        [--configs 512:auto:int8,1024:auto:int8:chunk64] [--device cpu]

A configuration is ti:r_sub:precision[:flag...], the reference's syntax.
The flags are chunkK (tiles a launch; default the reference's 64
512x512-equivalents, max(1, (512 // ti) * 64)) and fpbK (the truncation
band of truncate_values). The reference's Pallas knobs have no
counterpart in K2: r_sub other than auto, a precision other than int8
(K2 counts on 1-bit tensor cores) and an fpbK other than
ops/screen.FP_BAND_LOG2 print an error row for that configuration, and
the sweep goes on, as the reference's does for a configuration that
fails.

Each configuration sums S and Z in f32 over --tiles random tile pairs
(numpy seed 3), padded to whole launches, and keeps the best of --reps
sweeps after one warm-up: pairs_per_sec counts the launched tiles' ti^2
pairs, tc_util the rate's 2^14 comparisons a bin against
utils/hopper.B1_COMPARISONS_PER_S (null with --device cpu). It reads the
sweep's answer and changes nothing: the engine's auto_tile / auto_chunk
stay as they are.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import screen
from ..utils import hopper, hostmem, synth
from ..utils.device import resolve

P = synth.BENCH_P
DEFAULT_CONFIGS = ("512:auto:int8,1024:auto:int8,512:2048:int8,"
                   "256:auto:int8")


def parse(cfg):
    """(ti, chunk) of a configuration; ValueError for a knob K2 has
    no counterpart for."""
    ti_s, rsub_s, prec, *flags = cfg.split(":")
    fpb = next((int(f[3:]) for f in flags if f.startswith("fpb")), None)
    if rsub_s != "auto":
        raise ValueError(f"r_sub={rsub_s}: a Pallas knob K2 has no "
                         "counterpart for (auto only)")
    if prec != "int8":
        raise ValueError(f"precision={prec}: K2 counts on 1-bit tensor "
                         "cores (int8 only)")
    if fpb not in (None, screen.FP_BAND_LOG2):
        raise ValueError(f"fpb{fpb}: truncate_values keeps fp_band_log2 = "
                         f"{screen.FP_BAND_LOG2}")
    ti = int(ti_s)
    chunk = next((int(f[5:]) for f in flags if f.startswith("chunk")),
                 max(1, (512 // ti) * 64))
    return ti, chunk


def sweep_config(d_regs, values, ti, chunk, tiles, reps, rng):
    """(pairs/s, checksum) of K2 over `tiles` random tile pairs of the
    resident bank, best of reps after one warm-up."""
    nb = d_regs.shape[0] // ti
    dev = d_regs.device

    def sweep():
        rows = rng.integers(0, nb, tiles).astype(np.int32)
        cols = rng.integers(0, nb, tiles).astype(np.int32)
        sums = []
        for c0 in range(0, tiles, chunk):
            r, c = rows[c0:c0 + chunk], cols[c0:c0 + chunk]
            if len(r) < chunk:
                r = np.pad(r, (0, chunk - len(r)), constant_values=r[-1])
                c = np.pad(c, (0, chunk - len(c)), constant_values=c[-1])
            s, z = screen.screen_s_z(d_regs, torch.from_numpy(r).to(dev),
                                     torch.from_numpy(c).to(dev), P, values,
                                     ti=ti, tj=ti)
            tot = torch.sum(s, dtype=torch.float32)
            if z is not None:
                tot = tot + torch.sum(z, dtype=torch.float32)
            sums.append(tot)
        return float(torch.stack(sums).sum())

    checksum = sweep()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sweep()
        best = min(best, time.perf_counter() - t0)
    return -(-tiles // chunk) * chunk * ti * ti / best, checksum


def rows(configs, n=16384, tiles=256, reps=3, device=None, bank=None):
    """One record a configuration: config, n_values, pairs_per_sec,
    tc_util; or config and error. bank: optional (regs, aux, e) of
    synth.bench_bank(n)."""
    dev = resolve(device)
    regs, _, e = synth.bench_bank(n) if bank is None else bank
    values = screen.truncate_values(screen.bank_values(regs), float(e.max()),
                                    P)
    d_regs = torch.from_numpy(np.ascontiguousarray(regs)).to(dev)
    rng = np.random.default_rng(3)
    for cfg in configs.split(","):
        try:
            ti, chunk = parse(cfg)
            rate, _ = sweep_config(d_regs, values, ti, chunk, tiles, reps,
                                   rng)
            yield {"config": cfg, "n_values": len(values),
                   "pairs_per_sec": rate, "tc_util": (
                       rate * (len(values) - 1) * (1 << P)
                       / hopper.B1_COMPARISONS_PER_S
                       if dev.type == "cuda" else None)}
        except Exception as exc:  # noqa: BLE001 - report, go on
            yield {"config": cfg,
                   "error": f"{type(exc).__name__}: {exc}"[:300]}


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="kernel_tuning", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiles", type=int, default=256,
                    help="tiles per sweep (each ti x ti pairs)")
    ap.add_argument("--configs", default=DEFAULT_CONFIGS,
                    help="comma list of ti:r_sub:precision[:flag...]; "
                         "flags chunkK, fpbK")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs K2's plain "
                         "version)")
    args = ap.parse_args(argv)
    for row in rows(args.configs, args.n, args.tiles, args.reps,
                    args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
