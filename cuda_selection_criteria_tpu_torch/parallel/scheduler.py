"""Pair-block scheduler: tiles the i<j triangle and skips blocks the
cardinality bound (CB) rules out. Host numpy, copied from
cuda_selection_criteria_tpu/parallel/scheduler.py so tile schedules stay
bit-equal to the reference's.

gamma = e_i / e_j is non-increasing along a row sorted by ascending
cardinality, so a whole (row-block, col-block) tile is dead iff its best
pair fails CB:

    max_{i in rows} e_i / min_{j in cols, e_j > 0} e_j < tau  =>  skip tile.
"""

import numpy as np


def block_ranges(n, block):
    """[(start, stop)) ranges tiling [0, n) in chunks of `block`."""
    return [(s, min(s + block, n)) for s in range(0, n, block)]


def triangle_block_ids(e_sorted, tau, block, use_cb_skip=True):
    """Vectorized tile enumeration: (rows, cols) int64 block indices.

    For each row block bi, column blocks bj >= bi are visited in order; a
    block whose columns are all zero-cardinality is skipped (never
    emitted, never breaks the row); the first positive block with
    gamma_ub < tau breaks the row. The emitted set comes from the same
    f64 divisions and comparisons as the reference's scalar scan, so
    borderline floats agree bit-for-bit.
    """
    n = int(e_sorted.shape[0])
    if n == 0:
        return (np.zeros(0, np.int64),) * 2
    nb = -(-n // block)
    ii = np.arange(nb)
    starts = ii * block
    ends = np.minimum(starts + block, n)
    upper = ii[None, :] >= ii[:, None]  # bj >= bi

    if not use_cb_skip:
        rows, cols = np.nonzero(upper)
        return rows, cols

    e = np.asarray(e_sorted, np.float64)
    e1_max = e[ends - 1]  # ascending within the block
    # first positive value per block; +inf marks all-zero blocks
    k0 = int(np.searchsorted(e, 0.0, side="right"))
    first_pos_idx = np.maximum(starts, k0)
    has_pos = first_pos_idx < ends
    first_pos = np.where(has_pos, e[np.minimum(first_pos_idx, n - 1)],
                         np.inf)

    with np.errstate(divide="ignore", invalid="ignore"):
        gamma_ub = e1_max[:, None] / first_pos[None, :]
    live = gamma_ub >= tau
    fail = upper & has_pos[None, :] & ~live
    cut = np.where(fail.any(axis=1), fail.argmax(axis=1), nb)
    keep = upper & has_pos[None, :] & (ii[None, :] < cut[:, None])
    rows, cols = np.nonzero(keep)
    return rows, cols


def triangle_blocks(e_sorted, tau, block, use_cb_skip=True):
    """(row_range, col_range) tiles of the upper triangle that can contain
    selected pairs: [((r0, r1), (c0, c1)), ...] in schedule order."""
    n = int(e_sorted.shape[0])
    rows, cols = triangle_block_ids(e_sorted, tau, block, use_cb_skip)
    r0 = rows * block
    c0 = cols * block
    r1 = np.minimum(r0 + block, n)
    c1 = np.minimum(c0 + block, n)
    return [((int(a), int(b)), (int(c), int(d)))
            for a, b, c, d in zip(r0, r1, c0, c1)]


def triangle_blocks_scalar(e_sorted, tau, block, use_cb_skip=True):
    """The reference's scalar scan, kept as the semantic oracle that
    triangle_block_ids is fuzz-tested against (the engines use the
    vectorized form)."""
    n = e_sorted.shape[0]
    ranges = block_ranges(n, block)
    tiles = []
    for bi, (r0, r1) in enumerate(ranges):
        e1_max = float(e_sorted[r1 - 1])
        for bj in range(bi, len(ranges)):
            c0, c1 = ranges[bj]
            if use_cb_skip:
                col = e_sorted[c0:c1]
                pos = col[col > 0]
                if pos.size == 0:
                    continue  # e2 == 0 pairs are skipped, never selected
                gamma_ub = e1_max / float(pos[0])  # first positive is min
                if not gamma_ub >= tau:
                    # gamma only shrinks for later column tiles: the rest
                    # of the row of tiles is dead too
                    break
            tiles.append(((r0, r1), (c0, c1)))
    return tiles


def pair_count(tiles, n):
    """Number of i<j pairs covered by the scheduled tiles (for throughput
    accounting) - closed form per tile, no materialized index grids."""
    total = 0
    for (r0, r1), (c0, c1) in tiles:
        if c0 >= r1:  # strictly above the diagonal: full rectangle
            total += (r1 - r0) * (c1 - c0)
            continue
        jj = np.arange(max(c0, r0 + 1), c1)
        total += int(np.sum(np.minimum(r1, jj) - r0))
    return total
