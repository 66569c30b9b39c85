"""Transient-fault handling for the device path. Port of
cuda_selection_criteria_tpu/utils/resilience.py.

The reference tool has no failure handling at all: CUDA return codes are
unchecked (src/selection_cuda.cpp:160-180). Policy here: classify, back
off, free the allocator's cached blocks, retry the whole operation once
in-process. On a local card the recoverable fault is running out of device
memory; an error of the CUDA context itself (an illegal access, a launch
failure) is sticky, poisons every later call in the process and re-raises
at once. Long sweeps additionally keep per-span progress
(ScreenPlan.screen_tiles(checkpoint=...)), so even a process death resumes
without recomputing completed work.
"""

import sys
import time

import torch

# Message tags of backend faults that an immediate retry survives.
TRANSIENT_TAGS = ("FAILED_PRECONDITION", "UNAVAILABLE", "DEADLINE_EXCEEDED",
                  "RESOURCE_EXHAUSTED", "connection", "Connection")


def is_sticky_cuda_error(exc):
    """An error of the CUDA context: every later call in the process fails
    too, so retrying in-process cannot help."""
    accel = getattr(torch, "AcceleratorError", None)
    return ((accel is not None and isinstance(exc, accel))
            or (isinstance(exc, RuntimeError)
                and str(exc).startswith("CUDA error")))


def is_transient(exc):
    """Heuristic classification of recoverable device faults."""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    if is_sticky_cuda_error(exc):
        return False
    msg = str(exc)
    return any(tag in msg for tag in TRANSIENT_TAGS)


def run_with_transient_retry(fn, max_attempts=2, backoff=15.0):
    """Run fn(); on a transient device fault, back off, release the CUDA
    allocator's cached blocks, and retry (max_attempts in all)."""
    for attempt in range(1, max_attempts + 1):
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 - classified below
            if attempt >= max_attempts or not is_transient(exc):
                raise
            print(
                f"transient device fault (attempt {attempt}/"
                f"{max_attempts}): {type(exc).__name__}: "
                f"{str(exc)[:200]}; retrying in {backoff:.0f}s",
                file=sys.stderr, flush=True,
            )
            time.sleep(backoff)
            torch.cuda.empty_cache()  # a no-op where CUDA never started
