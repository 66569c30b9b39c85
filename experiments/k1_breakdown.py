#!/usr/bin/env python3
"""Where the time of kernel K1 goes: builds variants of
cuda_selection_criteria_tpu_torch/csrc/screen_fused.cu with one part taken
out and times each on the dense 64-tile launch of chip_smoke.py's phase 3
(the hll_a primary call at p=14, ti=1024 on the N=16384 hll bench bank).

    python3 experiments/k1_breakdown.py     # needs one CUDA card

Variants (only `base` computes the screen; the others are timing probes):
  base            the kernel as it is (checked bit-equal to the plain
                  version)
  no_mma          without the wgmma: the pack, the gates, the cp.async ring,
                  the folds and the epilogue
  no_load         without the cp.async copies: the mma runs on whatever
                  shared memory holds
  no_load_no_mma  the pack, the gates, the barriers, the folds and the
                  epilogue
  pack_only       the pack stage alone
  tile_addressed  the planes addressed by the tiles' block ids, not by
                  their slots in the launch's block list: equal to base on
                  this launch, whose list is every block of the bank in
                  order, so the two differ only by the slot reads
Each is built with nvcc into the port's build directory (its registers
from ptxas printed) and timed with CUDA events beside the card's name and
power limit.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cuda_selection_criteria_tpu_torch import models  # noqa: E402
from cuda_selection_criteria_tpu_torch.ops import _build, screen  # noqa: E402
from cuda_selection_criteria_tpu_torch.parallel import (  # noqa: E402
    scheduler, screened)
from cuda_selection_criteria_tpu_torch.parallel.selection import (  # noqa
    SelectionParams)
from cuda_selection_criteria_tpu_torch.utils import synth  # noqa: E402

MMA = ("          wgmma_b1(acc[b], smem_desc(sa + kk * 32), "
       "smem_desc(sb + kk * 32));")
LOAD = "  auto load_stage = [&](int s) {\n"
PACK = "  const int smem = kAtom + kRingBytes"
SLOTS = ("  const int rplane = row_slot[t] * ti + lr0;\n"
         "  const int cplane = col_slot[t] * ti + lc0;\n")
VARIANTS = {
    "base": [],
    "no_mma": [(MMA, "          ;")],
    "no_load": [(LOAD, LOAD + "    return;\n")],
    "no_load_no_mma": [(MMA, "          ;"), (LOAD, LOAD + "    return;\n")],
    "pack_only": [(PACK, "  return (int)err;\n" + PACK)],
    "tile_addressed": [(SLOTS, SLOTS.replace("row_slot", "row_tiles")
                        .replace("col_slot", "col_tiles"))],
}


def build_variants():
    """{name: (library path, ptxas's register lines)}; one nvcc per
    variant, all started together."""
    src = open(_build.source("screen_fused")).read()
    out_dir = os.path.join(_build.BUILD_DIR, "k1_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    procs, paths = {}, {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source changed")
            text = text.replace(old, new)
        # beside the original, so that its #include finds pack_planes.cuh
        cu = os.path.join(_build.CSRC, f"_k1_breakdown_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        paths[name] = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (cu, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", paths[name], cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (cu, proc) in procs.items():
        log = proc.communicate()[0]
        os.remove(cu)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        paths[name] = (paths[name], [ln.strip() for ln in log.splitlines()
                                     if "registers" in ln])
    return paths


def main():
    if not torch.cuda.is_available():
        print("k1_breakdown: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    dev = torch.device("cuda")
    paths = build_variants()
    bank, _ = cs.hll_bench_bank(models, synth, 16384,
                                np.random.default_rng(0x4A11), 300)
    plan = screened.ScreenPlan(bank, SelectionParams(tau=0.9,
                                                     criterion="hll_a"),
                               1024, device=dev)
    rows, cols = scheduler.triangle_block_ids(plan.e_s, plan.tau, 1024,
                                              use_cb_skip=False)
    chunk = screened.auto_chunk(1024)
    tiles = screen.launch_tiles(rows[:chunk], cols[:chunk], True, dev)
    if not torch.equal(tiles.row_blocks.cpu(),
                       torch.arange(plan.n_pad // 1024, dtype=torch.int32)):
        raise RuntimeError("k1_breakdown: the launch does not read every "
                           "block, so tile_addressed would differ")
    args = [plan.d_bank, tiles, plan.d_e, plan.d_fp]
    kw = dict(n_real=plan.n, tau_scr=plan.tau_scr, tau_cb=plan.tau_cb, p=14,
              values=plan.values, ti=1024, n_bands=1, use_cb=True,
              use_smh=False, row_map=plan.d_rows)
    want = screen._screen_hits_fused_plain(plan.d_bank, tiles.row_tiles,
                                           tiles.col_tiles, plan.d_e,
                                           plan.d_fp, **kw)
    entry, argtypes = _build.KERNELS["screen_fused"]
    print(card)
    for name, (path, regs_lines) in paths.items():
        print(f"{name}: " + "; ".join(regs_lines))
        lib = ctypes.CDLL(path)
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _build._loaded["screen_fused"] = lib  # the wrapper launches this
        got = screen.screen_hits_fused(*args, **kw)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        if name in ("base", "tile_addressed") and not equal:
            raise RuntimeError(f"k1_breakdown: {name} != plain")
        ms = cs.cuda_ms(torch, lambda: screen.screen_hits_fused(*args, **kw),
                        5)
        print(f"[{card}] K1 {name}: {ms:.3f} ms per dense launch of {chunk} "
              f"tiles" + (", bit-equal to plain" if equal else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
