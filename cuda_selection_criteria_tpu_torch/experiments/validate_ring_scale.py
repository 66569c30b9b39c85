"""Replication-scale validation of the ring engine. Port of the JAX
package's experiments/validate_ring_scale.py.

Runs select_pairs_ring (per-strip uploads, strip-level and tile-level CB
schedules, the gate pass, the chunked screen read in waves, the
candidate-row confirm) on the planted bench bank of validate_131k_scale.
Its mesh is every visible CUDA device by default, so on one card the bank
is one strip, as the reference harness is on one chip; run() takes any
("rows",) mesh. Prints one JSON line with the engine's stats, the wall,
pairs/s over the full triangle and the device memory; exits non-zero
unless the planted pairs come back (the screened harness's criterion). The
kernel library is loaded before the timed run (kernel_load_secs), so the
wall is the engine's steady state.

    python -m \\
        cuda_selection_criteria_tpu_torch.experiments.validate_ring_scale \\
        [--n 131072] [--tau 0.9] [--ti T] [--chunk-tiles C] [--device cpu]
"""

import argparse
import json
import sys
import time

import torch

from ..ops import _build, screen
from ..parallel.ring import select_pairs_ring
from ..parallel.selection import SelectionParams
from ..utils import hopper, hostmem, synth
from ..utils.device import resolve
from .validate_131k_scale import device_record, make_bank, planted_check


def run(bank, params, mesh=None, ti=None, chunk_tiles=None, device=None):
    """select_pairs_ring on `bank` (mesh and device as the engine takes
    them). Returns (record, pairs): record holds the engine's stats
    (upload_stats among them), the wall (total_secs), pairs/s over the
    full triangle with vs_baseline (against utils/hopper.card_baseline,
    measured once a process before the peak is reset; null off the card),
    K1's launches on its two entry points and the plan device's memory;
    pairs are reference-ordered [(name_i, name_j, jacc)]."""
    dev = resolve(device)
    baseline = hopper.card_baseline(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    k1_0 = (screen.screen_hits_fused.launches,
            screen.screen_hits_fused_strips.launches)
    stats = {}
    t0 = time.perf_counter()
    pairs = select_pairs_ring(bank, params, mesh=mesh, ti=ti,
                              chunk_tiles=chunk_tiles, stats=stats,
                              device=device)
    total = time.perf_counter() - t0
    tri_pairs = bank.n * (bank.n - 1) // 2
    record = {
        "engine": "ring", "n_genomes": bank.n, "pairs_emitted": len(pairs),
        **stats,
        "total_secs": total,
        "triangle_pairs_per_sec": tri_pairs / total,
        "vs_baseline": hopper.ratio(tri_pairs / total, baseline),
        "k1_launches": screen.screen_hits_fused.launches - k1_0[0],
        "k1_strip_launches": (screen.screen_hits_fused_strips.launches
                              - k1_0[1]),
        **device_record(dev),
    }
    return record, pairs


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="validate_ring_scale",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--tau", type=float, default=0.9)
    ap.add_argument("--ti", type=int, default=None,
                    help="screen tile size (default: the engine's auto rule)")
    ap.add_argument("--chunk-tiles", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) meshes every visible "
                         "card; cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)

    bank, picks, bank_secs = make_bank(args.n)
    print(f"bank: {args.n} genomes ({bank.regs.nbytes / 2**30:.2f} GiB "
          f"regs), {len(picks)} planted dup pairs, {bank_secs:.1f} s",
          flush=True)
    load_secs = 0.0
    if resolve(args.device).type == "cuda":
        t0 = time.perf_counter()
        _build.library("screen_fused")
        load_secs = time.perf_counter() - t0
    params = SelectionParams(tau=args.tau, criterion="smh_a",
                             aux_bytes=8 * synth.BENCH_M)
    record, pairs = run(bank, params, ti=args.ti,
                        chunk_tiles=args.chunk_tiles, device=args.device)
    record.update(planted_check(pairs, len(picks)), bank_secs=bank_secs,
                  kernel_load_secs=load_secs)
    print(json.dumps(record), flush=True)
    if not record["planted_recovered"]:
        print("planted duplicate pairs not recovered exactly",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
