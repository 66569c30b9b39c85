#!/usr/bin/env python3
"""Where the time of kernel K2 goes: builds variants of
cuda_selection_criteria_tpu_torch/csrc/weighted_cdf_sum.cu with one part
taken out and times each on the 64-tile launch of chip_smoke.py's phase 3
(the hll aux sums at p_aux=8, ti=1024 on the N=16384 hll bench bank).

    python3 experiments/k2_breakdown.py     # needs one CUDA card

Variants (only `base` computes S and Z; the others are timing probes):
  base      the kernel as it is (checked bit-equal to the plain version;
            the registers, spills and warnings of its ptxas log are printed)
  no_mma    without the wgmma: the pack, the cp.async ring, the folds and
            the stores
  no_load   without the cp.async copies: the mma runs on whatever shared
            memory holds
  no_fold   the fold's conversion, multiply and add replaced by one XOR
  no_store  without the S and Z stores
  stores_only  without the mma, the copies and the fold: the pack, the
            barriers, the loops and the stores
  bare      without the stores too: the pack, the launch, the barriers and
            the loops
  pack_only the pack stage alone
Each is built with nvcc into the port's build directory and timed with
CUDA events (the wrapper's host time included: the shortest variants are
bound by it) beside the card's name and power limit. A yardstick for the
stores is printed first: PyTorch zeroing tensors of S's and Z's size.
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

INCLUDE = '#include "wgmma_b1.cuh"\n'
NO_MMA = (INCLUDE, INCLUDE + "#define wgmma_b1(...) ((void)0)\n"
          "#define wgmma_b1_scaled(...) ((void)0)\n")
LOAD = "  auto load_stage = [&](int s) {\n"
NO_LOAD = (LOAD, LOAD + "    return;\n")
NO_FOLD = ("      sv[p] = __fadd_rn(sv[p], __fmul_rn(wk, (float)acc[p]));",
           "      sv[p] = __int_as_float(__float_as_int(sv[p]) ^ acc[p]);")
STORE = "      if (lc + (p >> 2) * 8 < n_cols)"
NO_STORE = (STORE, "      if (nbins < 0 && lc + (p >> 2) * 8 < n_cols)")
SUM = "  const int g = W / kStepWords;  // mma depths a bin\n"
VARIANTS = {
    "base": [],
    "no_mma": [NO_MMA],
    "no_load": [NO_LOAD],
    "no_fold": [NO_FOLD],
    "no_store": [NO_STORE],
    "stores_only": [NO_MMA, NO_LOAD, NO_FOLD],
    "bare": [NO_MMA, NO_LOAD, NO_FOLD, NO_STORE],
    "pack_only": [(SUM, "  return (int)err;\n" + SUM)],
}


def build_variants():
    """{name: (library path, compiler log)}; one nvcc per variant, all
    started together."""
    src = open(_build.source("weighted_cdf_sum")).read()
    out_dir = os.path.join(_build.BUILD_DIR, "k2_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    procs, out = {}, {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source changed")
            text = text.replace(old, new)
        # beside the original, so that its #include finds the headers
        cu = os.path.join(_build.CSRC, f"_k2_breakdown_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        path = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (cu, path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (cu, path, proc) in procs.items():
        log = proc.communicate()[0]
        os.remove(cu)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (path, log)
    return out


def main():
    if not torch.cuda.is_available():
        print("k2_breakdown: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain: exact f32
    card = cs.card_line()
    dev = torch.device("cuda")
    built = build_variants()
    bank, _ = cs.hll_bench_bank(models, synth, 16384,
                                np.random.default_rng(0x4A11), 300)
    plan = screened.ScreenPlan(bank, SelectionParams(tau=0.9,
                                                     criterion="hll_a"),
                               1024, device=dev)
    rows, cols = scheduler.triangle_block_ids(plan.e_s, plan.tau, 1024,
                                              use_cb_skip=False)
    chunk = screened.auto_chunk(1024)
    args = [plan.d_aux_regs,
            torch.from_numpy(rows[:chunk].astype(np.int32)).to(dev),
            torch.from_numpy(cols[:chunk].astype(np.int32)).to(dev)]
    kw = dict(p=8, values=plan.values_aux, ti=1024, tj=1024)
    want = screen._screen_s_z_plain(*args, **kw)
    entry, argtypes = _build.KERNELS["weighted_cdf_sum"]
    print(card)
    fill = [torch.empty_like(x) for x in want if x is not None]
    ms = cs.cuda_ms(torch, lambda: [x.zero_() for x in fill], 10)
    print(f"[{card}] zeroing {len(fill)} tensors of S's size "
          f"({sum(x.numel() * 4 for x in fill)} bytes): {ms:.3f} ms")
    del fill
    for line in built["base"][1].splitlines():
        if any(word in line for word in ("registers", "spill", "arning")):
            print("  ptxas (base): " + line.strip())
    for name, (path, _) in built.items():
        lib = ctypes.CDLL(path)
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _build._loaded["weighted_cdf_sum"] = lib  # the wrapper launches this
        got = screen.screen_s_z(*args, **kw)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        if name == "base" and not equal:
            raise RuntimeError("k2_breakdown: base != plain")
        del got
        ms = cs.cuda_ms(torch, lambda: screen.screen_s_z(*args, **kw), 10)
        print(f"[{card}] K2 {name}: {ms:.3f} ms per launch of {chunk} tiles "
              f"at p_aux=8, {len(plan.values_aux) - 1} bins"
              + ("" if name != "base" else ", bit-equal to plain"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
