"""Replication-scale validation of the screened engine. Port of the JAX
package's experiments/validate_131k_scale.py.

Builds the reference bench's synthetic bank (utils/synth.bench_bank: N
genomes of 2048 hashes at p=14 with 32 SMH buckets; N=131,072 is 2 GiB of
registers) with 128 planted near-duplicate pairs, so the cascade has real
survivors, and drives the screened engine's cascade stage by stage:

    ScreenPlan (the bank's upload, row histograms and present values,
                sort, fingerprints)
    ->  schedule (host tiling + block CB)  ->  gate warm-up (2 tiles)
    ->  gate prune  ->  one warm-up screen launch
    ->  chunked screen in waves (K1)
    ->  exact confirm

Prints one JSON line: each stage's wall, the tile, candidate and pair
counts, pairs/s over the full triangle, K1's launches, and the card's peak
allocated memory beside its total. The upload is its own stage
(upload_secs, out of plan_secs). A gate prune of two tiles and one
screen launch come first: they load the gate's torch kernels and K1's
library, per-process costs that are left out of total_secs
(gate_warmup_secs, screen_warmup_secs), as the reference leaves out its
compile walls; total_with_warmup_secs keeps them. The confirm stage is not
warmed, as in the reference, so its first use stays in total_secs.
Exits non-zero unless the planted pairs come back (the reference's
criterion: at least as many pairs as planted, every Jaccard above 0.9).

    python -m \\
        cuda_selection_criteria_tpu_torch.experiments.validate_131k_scale \\
        [--n 131072] [--tau 0.9] [--ti T] [--chunk C] [--wave 48] \\
        [--device cpu]
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from ..models import SketchBank
from ..models.bank import host_cards
from ..ops import screen
from ..parallel.screened import ScreenPlan, auto_chunk, auto_tile
from ..parallel.selection import SelectionParams
from ..utils import hopper, hostmem, synth
from ..utils.device import resolve

PLANT_SEED = 0x131  # the reference harness's planting draws


def planted_bank(n, rng, n_dups=128):
    """(regs, aux, e, picks): bench_bank(n) with n_dups planted
    near-duplicate pairs (picks[k], picks[k] + 1), bit-equal to the
    reference harness's planted_bank: row i + 1 becomes row i with four
    registers raised by one and an identical SMH row, so the banding gate
    passes the pair like a true near-duplicate; then the planted rows'
    cardinalities are recomputed exactly. The picks are planted in the
    order rng.choice draws them, as the reference does (a pick whose
    successor is also picked is overwritten differently in sorted order),
    so this keeps its own loop rather than synth.plant_near_duplicates,
    which sorts them first."""
    regs, aux, e = synth.bench_bank(n)
    picks = rng.choice(n - 1, size=n_dups, replace=False)
    for i in picks:
        regs[i + 1] = regs[i]
        regs[i + 1, rng.integers(0, regs.shape[1], 4)] += 1
        aux[i + 1] = aux[i]
    rows = np.unique(np.concatenate([picks, picks + 1]))
    e[rows] = np.trunc(host_cards(regs[rows], synth.BENCH_P))
    return regs, aux, e, picks


def make_bank(n, n_dups=128):
    """(SketchBank, picks, seconds) of planted_bank(n) with the reference
    harness's seed and names."""
    t0 = time.perf_counter()
    regs, aux, e, picks = planted_bank(n, np.random.default_rng(PLANT_SEED),
                                       n_dups)
    bank = SketchBank(names=[f"g{i:06d}" for i in range(n)], regs=regs,
                      p=synth.BENCH_P, cards=e, aux_kind="smh", aux=aux,
                      aux_param=synth.BENCH_M)
    return bank, picks, time.perf_counter() - t0


def planted_check(pairs, n_dups):
    """The reference harness's criterion (validate_131k_scale.py:185): at
    least n_dups pairs emitted, every Jaccard above 0.9."""
    jaccs = [j for *_, j in pairs]
    return {"planted_dups": int(n_dups),
            "planted_recovered": bool(len(pairs) >= n_dups
                                      and (not jaccs or min(jaccs) > 0.9)),
            "min_jacc": min(jaccs) if jaccs else None}


def device_record(dev):
    """The device's name, and on CUDA the peak allocated bytes since the
    last reset_peak_memory_stats and the card's total memory; the host
    process's peak resident set and the host's total memory."""
    rec = {"device": str(dev), "peak_allocated_bytes": None,
           "device_total_bytes": None}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        rec.update(device=torch.cuda.get_device_name(dev),
                   peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
                   device_total_bytes=torch.cuda.get_device_properties(
                       dev).total_memory)
    # ru_maxrss is in KiB on Linux
    rec["host_peak_rss_bytes"] = (
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    rec["host_total_bytes"] = (os.sysconf("SC_PAGE_SIZE")
                               * os.sysconf("SC_PHYS_PAGES"))
    return rec


def run(bank, params, ti=None, chunk=None, wave=48, device=None):
    """The screened cascade on `bank`, stage by stage, in the reference
    harness's order. Returns (record, pairs): record holds each stage's
    wall (plan_secs without the upload, upload_secs, schedule_secs,
    gate_warmup_secs, prune_secs, screen_warmup_secs, screen_secs,
    confirm_secs; the two warm-ups are left out of total_secs), the gate
    prune's stats, the plan's upload_stats and fp_secs (the band
    fingerprints' wall, inside plan_secs), the device bank's bytes and
    on CUDA plan_peak_allocated_bytes (the most the card's allocator held
    during ScreenPlan beyond what it held when the run began), the counts,
    the throughput over the full triangle with vs_baseline and
    resident_vs_baseline (against utils/hopper.card_baseline, measured
    once a process before the peak is reset; null off the card), K1's
    launches and the device memory; pairs are reference-ordered
    [(name_i, name_j, jacc)]."""
    dev = resolve(device)
    baseline = hopper.card_baseline(dev)
    ti = auto_tile(bank.n) if ti is None else ti
    chunk = auto_chunk(ti) if chunk is None else chunk
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    k1_0 = screen.screen_hits_fused.launches
    stages = {}
    t0 = time.perf_counter()
    plan = ScreenPlan(bank, params, ti, dev)
    plan_peak = (torch.cuda.max_memory_allocated(dev) - held if cuda
                 else None)
    stages["plan_secs"] = time.perf_counter() - t0 - plan.upload_secs
    stages["upload_secs"] = plan.upload_secs

    t0 = time.perf_counter()
    rows, cols = plan.schedule()
    stages["schedule_secs"] = time.perf_counter() - t0
    n_sched = len(rows)

    # The gate's first chunk loads its torch kernels: a per-process cost,
    # paid on two tiles first and timed on its own, as the reference warms
    # its gate executable.
    t0 = time.perf_counter()
    plan.prune_tiles(rows[:2], cols[:2], chunk=256)
    stages["gate_warmup_secs"] = time.perf_counter() - t0

    prune = {}
    t0 = time.perf_counter()
    rows, cols = plan.prune_tiles(rows, cols, chunk=256, stats=prune)
    stages["prune_secs"] = time.perf_counter() - t0

    # The first launch loads the kernel library (and builds it when the
    # build directory has none): a per-process cost, timed on its own.
    t0 = time.perf_counter()
    if len(rows):
        _, cnt = plan.screen_chunk(
            np.pad(rows[:1], (0, chunk - 1), constant_values=rows[0]),
            np.pad(cols[:1], (0, chunk - 1), constant_values=cols[0]))
        cnt.cpu()
    stages["screen_warmup_secs"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cand = plan.screen_tiles(rows, cols, chunk=chunk, wave=wave)
    stages["screen_secs"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    confirmed = plan.confirm(cand)
    stages["confirm_secs"] = time.perf_counter() - t0

    warmup = stages["gate_warmup_secs"] + stages["screen_warmup_secs"]
    total = sum(stages.values()) - warmup
    resident = total - stages["plan_secs"] - stages["upload_secs"]
    tri_pairs = bank.n * (bank.n - 1) // 2
    names, order = bank.names, plan.order
    pairs = [(names[order[i]], names[order[j]], jacc)
             for i, j, jacc in confirmed]
    record = {
        "n_genomes": bank.n, "ti": ti, "chunk": chunk, "wave": wave,
        "tiles_scheduled": n_sched, "tiles_live": len(rows),
        "candidates": len(cand), "pairs_emitted": len(pairs),
        **stages, **prune,
        "upload_stats": plan.upload_stats,
        "fp_secs": plan.fp_secs,
        "device_bank_bytes": plan.d_bank.nbytes,
        "plan_peak_allocated_bytes": plan_peak,
        "total_secs": total,
        "total_with_warmup_secs": total + warmup,
        "triangle_pairs_per_sec": tri_pairs / total,
        "vs_baseline": hopper.ratio(tri_pairs / total, baseline),
        "resident_secs": resident,
        "resident_pairs_per_sec": tri_pairs / resident,
        "resident_vs_baseline": hopper.ratio(tri_pairs / resident, baseline),
        "k1_launches": screen.screen_hits_fused.launches - k1_0,
        **device_record(dev),
    }
    return record, pairs


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="validate_131k_scale",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--tau", type=float, default=0.9)
    ap.add_argument("--ti", type=int, default=None,
                    help="screen tile size (default: the engine's auto rule)")
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--wave", type=int, default=48)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    bank, picks, bank_secs = make_bank(args.n)
    print(f"bank: {args.n} genomes ({bank.regs.nbytes / 2**30:.2f} GiB "
          f"regs), {len(picks)} planted dup pairs, {bank_secs:.1f} s",
          flush=True)
    params = SelectionParams(tau=args.tau, criterion="smh_a",
                             aux_bytes=8 * synth.BENCH_M)
    record, pairs = run(bank, params, args.ti, args.chunk, args.wave,
                        args.device)
    record.update(planted_check(pairs, len(picks)), bank_secs=bank_secs)
    print(json.dumps(record), flush=True)
    if not record["planted_recovered"]:
        print("planted duplicate pairs not recovered exactly",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
