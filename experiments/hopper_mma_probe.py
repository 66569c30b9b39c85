#!/usr/bin/env python3
"""Issue rates of the two tensor-core routes for kernel K1's CDF counts on
one NVIDIA Hopper card: int8 `mma.sync m16n8k32` and 1-bit
`mma.sync m16n8k256 .and.popc`, each alone on all SMs at 2, 4 and 8 warps
an SM partition, the int8 route's whole inner step (ldmatrix, [x <= v]
indicators in registers, mma) for a 64 x 32 and a 64 x 64 warp tile, and
the 1-bit `wgmma.mma_async m64n128k256` from shared memory that K1 issues.

    python3 experiments/hopper_mma_probe.py     # needs one CUDA card

Builds experiments/hopper_mma_probe.cu with nvcc for sm_90a into the
port's build directory and prints, for each kind, mma instructions per
second and register comparisons per second (4096 a int8 mma, 32768 a b1
mma), beside the card's name and power limit.
"""

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from cuda_selection_criteria_tpu_torch.ops import _build  # noqa: E402

KINDS = {  # kind -> (label, mma a block-iteration, comparisons an mma)
    0: ("int8 mma.sync m16n8k32 alone", 64, 4096),
    1: ("b1 mma.sync m16n8k256 and.popc alone", 64, 32768),
    2: ("int8 step, 64x32 warp tile (ldmatrix + indicators + 16 mma)", 128,
        4096),
    3: ("int8 step, 64x64 warp tile (ldmatrix + indicators + 32 mma)", 256,
        4096),
    4: ("b1 mma.sync alone, 16 chains a warp", 128, 32768),
    5: ("b1 mma.sync alone, 4 chains a warp", 32, 32768),
    6: ("b1 wgmma m64n128k256 and.popc alone, 2 warpgroups a block", 8,
        64 * 128 * 256),
}


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libhopper_mma_probe.so")
    log = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
         os.path.join(HERE, "hopper_mma_probe.cu")],
        capture_output=True, text=True, check=True)
    print(log.stdout.strip())
    lib = ctypes.CDLL(lib_path)
    lib.probe_ms.argtypes = [ctypes.c_int] * 3
    lib.probe_ms.restype = ctypes.c_float
    print(card)
    for kind, (label, per_iter, cmp_per_mma) in KINDS.items():
        # 256-thread blocks: 132 * k blocks put 2k warps on each of the
        # 4 SM partitions of the 132 SMs
        for blocks in ((132 * 4,) if kind in (0, 2, 3)
                       else (132, 132 * 2, 132 * 4)):
            iters = 20000 if kind in (0, 1) else 4000
            ms = lib.probe_ms(kind, blocks, iters)
            if ms <= 0:
                raise RuntimeError(f"kind {kind} failed: cudaError_t {-ms}")
            mmas = blocks * iters * per_iter
            rate = mmas / ms * 1e3
            print(f"[{card}] {label}, {blocks // 66} warps a partition "
                  f"({blocks} blocks): "
                  f"{ms:.3f} ms, {rate:.4g} mma/s, {rate * cmp_per_mma:.4g} "
                  f"register comparisons/s "
                  f"({2 * rate * cmp_per_mma / 1e12:.1f} T ops/s)")


if __name__ == "__main__":
    main()
