"""Wall-clock timing with device synchronization. Port of
cuda_selection_criteria_tpu/utils/timer.py.

The reference's TIMERSTART/TIMERSTOP chrono macros
(include/metrictime2.hpp:9-17) print `label: N.XXXs`; its CUDA variant
stops the clock before the device finishes
(experiments/src/time_smh_cuda.cpp:279-283). Here a timed region waits
for the tensors handed to it, so a card's timings measure execution, not
the enqueue.
"""

import contextlib
import time

import torch


def block_until_ready(x):
    """Wait until the device work behind x is done: synchronizes CUDA when
    any tensor in x (a tensor, or lists, tuples and dict values of them)
    lives there. Returns x."""
    stack = [x]
    while stack:
        y = stack.pop()
        if isinstance(y, torch.Tensor):
            if y.is_cuda:
                torch.cuda.synchronize(y.device)
                break
        elif isinstance(y, dict):
            stack.extend(y.values())
        elif isinstance(y, (list, tuple)):
            stack.extend(y)
    return x


class Timer:
    def __init__(self, label):
        self.label = label
        self.seconds = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False

    def csv_row(self):
        return f"# elapsed time ({self.label}): {self.seconds:.3f}s"


@contextlib.contextmanager
def device_timer(label, results_holder=None):
    """Times a region; call holder.sync(x) on device outputs inside to make
    them complete before the clock stops. results_holder, a dict, receives
    label -> seconds."""
    t = Timer(label)

    class _Holder:
        def sync(self, x):
            return block_until_ready(x)

    t0 = time.perf_counter()
    yield _Holder(), t
    t.seconds = time.perf_counter() - t0
    if results_holder is not None:
        results_holder[label] = t.seconds
