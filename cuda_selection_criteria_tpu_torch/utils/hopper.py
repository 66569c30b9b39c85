"""The card's rates that the port's bounds and its bench count with, one
source for chip_smoke.py's bounds and experiments/bench.py.

B1_COMPARISONS_PER_S: register comparisons (one bin of one register of one
pair) a second of `wgmma.mma_async m64n128k256 .b1 .and.popc`, the fastest
route experiments/hopper_mma_probe.py measured on an NVIDIA H100 80GB HBM3
at 700 W (b1 mma.sync: 5.19e15); above the int8 tensor cores' published
1,979e12 ops/s (989.5e12 comparisons), so the bounds and the bench's
tensor-core utilization use it. HBM_BYTES_PER_S: the H100 SXM's published
3.35 TB/s of device memory. INT32_OPS_PER_S: int32 operations a second on
the CUDA cores, 132 SMs x 64 INT32 lanes (the Hopper white paper's SM:
64 INT32 and 128 FP32 lanes) at the 1.98 GHz boost clock that the
published 67 TFLOP/s f32 rate assumes (132 x 128 x 2 x 1.98e9); the gate
prune's bound.

The baseline of the bench's vs_baseline ratios is the reference CUDA
kernel's definition (bench.py of the JAX package: the union stage reads
both 16 KiB register rows of a pair, so device memory bounds it at
bandwidth / 32 KiB pairs a second, there 760 GB/s of an sm_86 card) with
this card's measured copy bandwidth in place of 760 GB/s.
"""

import subprocess

import torch

from .device import resolve

B1_COMPARISONS_PER_S = 7.889e15
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

_measured = {}  # CUDA device index -> bytes/s, measured once a process


def pairs_per_sec_bound(bytes_per_s, p=14):
    """Pairs a second of a union stage that reads both 2^p-byte register
    rows of every pair at bytes_per_s: the reference kernel's baseline."""
    return bytes_per_s / (2 * (1 << p))


def measured_hbm_bytes_per_s(device=None, nbytes=2 << 30, reps=8):
    """The card's device-memory rate in bytes a second: `reps` device-to-
    device copies of an nbytes uint8 buffer (2 GiB, 40 times the L2),
    timed with CUDA events after a warm-up copy, each copy counted as its
    read plus its write. Measured once a process for each device; raises
    on a device that is not CUDA (there is no CPU counterpart)."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"measured_hbm_bytes_per_s needs a CUDA device, "
                         f"not {dev}")
    key = torch.cuda.current_device() if dev.index is None else dev.index
    if key not in _measured:
        src = torch.ones(nbytes, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        dst.copy_(src)
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(dev):
            start.record()
            for _ in range(reps):
                dst.copy_(src)
            end.record()
        torch.cuda.synchronize(dev)
        _measured[key] = 2 * nbytes * reps / (start.elapsed_time(end) * 1e-3)
        del src, dst
    return _measured[key]


def hopper_baseline_pairs_per_sec(device=None, p=14):
    """The reference kernel's baseline on this card: its measured copy
    bandwidth over the 2 * 2^p bytes a pair."""
    return pairs_per_sec_bound(measured_hbm_bytes_per_s(device), p)


def card_baseline(device=None, p=14):
    """hopper_baseline_pairs_per_sec on a CUDA device, None on another:
    the baseline is the card's own, and a CPU run has none."""
    dev = resolve(device)
    return hopper_baseline_pairs_per_sec(dev, p) if dev.type == "cuda" \
        else None


def ratio(rate, baseline):
    """rate / baseline, None without a baseline (a vs_baseline key)."""
    return None if baseline is None else rate / baseline


def card_line():
    """The card's name and power limit as nvidia-smi gives them
    (`--query-gpu=name,power.limit --format=csv,noheader`), first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]
