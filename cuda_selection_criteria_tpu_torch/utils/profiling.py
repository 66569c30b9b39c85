"""Profiling and tracing helpers. Port of
cuda_selection_criteria_tpu/utils/profiling.py.

The reference's only instrumentation is a chrono macro pair printed as CSV
(include/metrictime2.hpp:9-17), and its GPU timings wrap the asynchronous
kernel launch only (experiments/src/time_smh_cuda.cpp:279-283). Here:

  * `timed()` wraps a region with a completion barrier on whatever the
    body stores in the yielded dict, so device work is inside the
    measurement;
  * `device_trace()` wraps a region in a torch.profiler trace (host and,
    where CUDA is available, device activity); the profile object is
    yielded for key_averages(), and a Chrome trace (Perfetto,
    chrome://tracing) is written when a directory is given.
"""

import os
import time
from contextlib import contextmanager

import torch

from .timer import block_until_ready


@contextmanager
def timed(label, sink=None):
    """Wall-clock a region; `sink(label, seconds)` or print a CSV row
    (`label;seconds`, the reference's TIMERSTART/TIMERSTOP shape)."""
    t0 = time.perf_counter()
    result = {}
    try:
        yield result
    finally:
        block_until_ready(result)
        dt = time.perf_counter() - t0
        if sink is not None:
            sink(label, dt)
        else:
            print(f"{label};{dt}")


@contextmanager
def device_trace(log_dir=None):
    """torch.profiler trace of the region; yields the profile. With
    log_dir, the trace is written to log_dir/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
