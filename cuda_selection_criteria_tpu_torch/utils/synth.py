"""Synthetic sketch banks with the register distribution of real builds.

Each genome gets `items` uniform 64-bit hashes (WangHash of distinct k-mers
is uniform) pushed through the reference's index/rank rule (hll.h:886-899):
index = top p bits, rank = clz(((h << 1) | 1) << (p - 1)) + 1, and a
register max-reduce - the rule of the reference package's bench bank
(bench.py:109-128), re-implemented here in numpy. SMH buckets are uniform
u64, so band fingerprints of unrelated genomes practically never collide.
"""

import numpy as np


def synthetic_regs(n, items, p, rng, chunk=1024):
    """uint8 (n, 2^p) registers of n genomes; `items` is the number of
    distinct hashes per genome, one int or an (n,) array."""
    counts = np.broadcast_to(np.asarray(items, np.int64), (n,))
    regs = np.zeros((n, 1 << p), np.uint8)
    for g0 in range(0, n, chunk):
        g = min(chunk, n - g0)
        cnt = counts[g0:g0 + g]
        h = rng.integers(0, 1 << 64, size=(g, int(cnt.max())),
                         dtype=np.uint64)
        idx = (h >> np.uint64(64 - p)).astype(np.int64)
        v = ((h << np.uint64(1)) | np.uint64(1)) << np.uint64(p - 1)
        # bit length by shift halving (exact, no float rounding)
        bl = np.zeros(v.shape, np.uint8)
        for sh in (32, 16, 8, 4, 2, 1):
            big = v >> np.uint64(sh)
            take = big != 0
            bl[take] += np.uint8(sh)
            v = np.where(take, big, v)
        rank = np.uint8(64) - bl  # clz + 1, since v > 0
        rank[np.arange(h.shape[1])[None, :] >= cnt[:, None]] = 0
        flat = np.arange(g)[:, None] * (1 << p) + idx
        sub = np.zeros(g * (1 << p), np.uint8)
        np.maximum.at(sub, flat.ravel(), rank.ravel())
        regs[g0:g0 + g] = sub.reshape(g, 1 << p)
    return regs


def synthetic_aux(n, m, rng):
    """uint64 (n, m) SMH buckets of unrelated genomes."""
    return rng.integers(0, 1 << 63, size=(n, m), dtype=np.uint64)


def plant_near_duplicates(regs, aux, rng, n_pairs, bumps=4):
    """Make n_pairs genomes near-duplicates of their predecessor, in place:
    row i+1 = row i with `bumps` registers raised by one, and identical
    SMH buckets, so the banding gate passes them like true near-duplicates
    (the reference package's planted-pair harness,
    experiments/validate_131k_scale.py:36-58). Returns the sorted pair
    indices i (pairs (i, i+1))."""
    picks = np.sort(rng.choice(regs.shape[0] - 1, size=n_pairs,
                               replace=False))
    for i in picks:
        regs[i + 1] = regs[i]
        regs[i + 1, rng.integers(0, regs.shape[1], bumps)] += 1
        aux[i + 1] = aux[i]
    return picks
