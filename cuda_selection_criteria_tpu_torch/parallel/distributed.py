"""Multi-host orchestration: torch.distributed bootstrap and tile-slice
ownership. Port of cuda_selection_criteria_tpu/parallel/distributed.py.

The screen is independent per tile, so hosts split the work without
exchanging any data:

  1. within a host: tiles split over the local devices
     (parallel/screened.select_pairs_screened_sharded), or the bank split
     into strips (parallel/ring.select_pairs_ring);
  2. across hosts (this module): every process computes the same schedule
     from the same cardinality sort, owns a contiguous slice of the live
     tile list, screens it and confirms its own survivors; the results are
     disjoint and merge in the reference's row order.

No collective runs in the selection itself, so the order in which
processes finish cannot change a bit. This is the only module of the port
that uses torch.distributed: for the process group's rank and size.
"""

import numpy as np
import torch
import torch.distributed as dist


def initialize(init_method=None, world_size=None, rank=None, backend=None):
    """Join the process group (a no-op for a single-process run, with
    init_method None, or when a group exists already).

    init_method: "tcp://host:port" or "file://path"; backend defaults to
    "nccl" where CUDA is present, else "gloo". A group created meanwhile
    by another caller is tolerated; any other failure raises."""
    if init_method is None or dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    except (RuntimeError, ValueError):
        if not dist.is_initialized():
            raise


def tile_slice(n_tiles, process_index=None, process_count=None):
    """Contiguous [lo, hi) slice of the live-tile list owned by a process:
    the process group's rank and size when one is initialized, else 0 of
    1. Deterministic given the shared cardinality sort, so every process
    takes its own part of the same schedule without coordination."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = (dist.get_world_size() if dist.is_initialized()
                         else 1)
    bounds = np.linspace(0, n_tiles, process_count + 1, dtype=np.int64)
    return int(bounds[process_index]), int(bounds[process_index + 1])


def select_pairs_multihost(bank, params, ti=512, chunk=64, device=None,
                           process_index=None, process_count=None):
    """This process's share of the screened all-pairs selection: the
    single-device cascade (ScreenPlan: schedule, this process's slice of
    it, gate prune, screen, confirm) on its tile slice. Returns
    [(i, j, name_i, name_j, jacc)] keyed by global sorted position: the
    shards of all processes are disjoint, and merge_multihost_results
    gives the single-host result. process_index / process_count name the
    slice (tile_slice) for a caller that knows it without a process
    group."""
    from .screened import ScreenPlan

    if bank.n < 2:
        return []
    plan = ScreenPlan(bank, params, ti, device)
    rows, cols = plan.schedule()
    lo, hi = tile_slice(len(rows), process_index, process_count)
    rows, cols = rows[lo:hi], cols[lo:hi]
    if not len(rows):
        return []
    rows, cols = plan.prune_tiles(rows, cols, chunk=max(chunk, 256))
    cand = plan.screen_tiles(rows, cols, chunk=chunk)
    names = bank.names
    order = plan.order
    return [(i, j, names[order[i]], names[order[j]], jacc)
            for i, j, jacc in plan.confirm(cand)]


def merge_multihost_results(shards):
    """Merge per-process shards into the reference row order:
    [(name_i, name_j, jacc)]."""
    merged = sorted({t for shard in shards for t in shard})
    return [(a, b, j) for _, _, a, b, j in merged]
