"""Host allocator tuning: keep freed numpy temporaries' pages for reuse.

The port's host stages (the bank's sort and pad, the exact confirm's
register scans, the loaders' stacks, npz checkpoint loads) churn through
numpy temporaries of up to hundreds of MB. glibc malloc serves a block
above M_MMAP_THRESHOLD (at most 32 MiB by its dynamic rule) with a fresh
mmap and unmaps it on free, so every such temporary faults its pages in
again. On the TPU host the reference package was written on (a micro-VM
whose guest memory is restored lazily), a gathered 134 MB temporary
faulted in at about 13 MB/s against about 60x that when the buffer was
reused: a TPU-host figure, not one of the card's host. The card
machine's own first-touch and reuse rates are in PERF.md section 5
(`experiments/hostmem_split.py`).

enable_arena_reuse raises M_MMAP_THRESHOLD and M_TRIM_THRESHOLD so that
blocks below the threshold come from the main arena, whose freed pages
are reused: the fault cost is paid once per high-water mark instead of
once per allocation. It changes the allocator of the whole process, so
only entry points call it (the CLIs' and the experiments' main,
chip_smoke.py), never an import or a library function. It does not
govern pinned host memory (torch's cudaHostAlloc arenas) nor blocks
taken in a worker thread's own arena, whose heaps are capped at 64 MiB
and map larger blocks whatever the threshold.

Copied from cuda_selection_criteria_tpu/utils/hostmem.py (which imports
only ctypes) with the same constants, latch and return value.
"""

import ctypes

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_enabled = None


def enable_arena_reuse(threshold_bytes=1 << 30):
    """Keep allocations below threshold_bytes in the reusable main arena.

    Idempotent (the first call's result is latched for the process); safe
    to call from every CLI / experiment entry point. Returns True when
    both mallopt calls took effect, False on a libc without mallopt or
    when a call fails.
    """
    global _enabled
    if _enabled is not None:
        return _enabled
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes))
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes)) and ok
        _enabled = ok
    except (OSError, AttributeError):
        _enabled = False
    return _enabled
