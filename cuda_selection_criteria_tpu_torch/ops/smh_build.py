"""Batched SuperMinHash bucket construction, as torch ops. Port of
cuda_selection_criteria_tpu/ops/smh_build.py (order-independent
reformulation of the reference's sequential loop,
sketch/include/sketch/bbmh.h:639-670):

    h[b] = min over items x and j in [0, m) with sigma_x(j) = b
               of (j << 32) | r_j(x)

where sigma_x is the Fisher-Yates permutation prefix of item x - a pure
min-reduce over independent per-item candidates, so items commute and
batches merge by element-wise min.

Buckets are uint64 values held as int64 bit patterns (ops/hashes). The
reference's empty bucket is U64_MAX, which is -1 as int64 and so would WIN
a signed min. Every candidate (j << 32) | r is below 2^63 (j < m), so the
reductions run with INT64_MAX as their internal empty marker, mapped to
the U64_MAX pattern only at the output; merges of finished sketches use
the unsigned min (hashes.umin).

Not carried over from the JAX package: its int32 bias trick, its dense
masked-min branch for <= 256 segments and its collision-splitting
sub-slots all work around serialized TPU scatters; one int64
scatter_reduce "amin" serves all three.
"""

import torch

from ..utils.device import as_tensor
from .hashes import INT64_MAX, U64_MAX, _srl, umin, wyrand_draws


def _candidates(kmers, m):
    """(buckets int64 (T, m), values int64 (T, m)): the target bucket
    sigma_x(j) and candidate (j << 32) | r_j of every item and j, for
    int64 k-mers on their own device."""
    t = kmers.shape[0]
    dev = kmers.device
    draws = wyrand_draws(kmers, m, dev)  # (T, m); one 64-bit draw per j
    # gen() call order per j: low 32 bits -> k, high 32 bits -> r
    # (reference: sketch/include/aesctr/wy.h:133-142, bbmh.h:650,657);
    # mod is "& (m-1)" (policy.h:21-23).
    k = draws & (m - 1)
    r = _srl(draws, 32)
    del draws
    # Fisher-Yates prefix, vectorized across items: p starts as identity
    # (the reference's lazy q_/i_ reset makes p fresh per item). Step j
    # swaps p[k_j] and p[j]; the candidate goes to bucket p[j] after the
    # swap, the old p[k_j] (equal to the old p[j] when k_j == j).
    perm = torch.arange(m, dtype=torch.int64, device=dev).repeat(t, 1)
    buckets = torch.empty((t, m), dtype=torch.int64, device=dev)
    for j in range(m):
        kj = k[:, j:j + 1]
        vj = perm[:, j:j + 1].clone()
        vk = perm.gather(1, kj)
        perm[:, j:j + 1] = vk
        perm.scatter_(1, kj, vj)
        buckets[:, j:j + 1] = vk
    j64 = torch.arange(m, dtype=torch.int64, device=dev) << 32
    return buckets, j64 | r


def smh_candidates(kmers, valid, m, device=None):
    """Per-item SuperMinHash candidates and their target buckets.

    kmers: (T,) canonical k-mers (the WyRand seeds; seed 0 -> 1337);
    valid: bool (T,), invalid items yield candidates of U64_MAX; m: bucket
    count (power of two). Returns (buckets int64 (T, m), cands int64 (T, m)
    holding the uint64 values (j << 32) | r_j)."""
    kmers = as_tensor(kmers, torch.int64, device)
    buckets, vals = _candidates(kmers, m)
    valid = as_tensor(valid, torch.bool, kmers.device)
    return buckets, torch.where(valid[:, None], vals, U64_MAX)


def _segment_min(vals, seg, n_seg):
    """Scatter-min of int64 candidates (all below INT64_MAX) into n_seg
    slots; empty slots come back as the U64_MAX pattern."""
    h = torch.full((n_seg,), INT64_MAX, dtype=torch.int64, device=vals.device)
    h.scatter_reduce_(0, seg, vals, "amin", include_self=True)
    return torch.where(h == INT64_MAX, U64_MAX, h)


def smh_build_batch_full(kmers, valid, genome_ids, m, n_genomes, device=None):
    """SuperMinHash h_ vectors for a batch of genomes in one reduce over
    every candidate. Returns int64 (n_genomes, m) uint64 patterns; empty
    buckets are U64_MAX, the reference's h_ initialization (bbmh.h:567)."""
    kmers = as_tensor(kmers, torch.int64, device)
    dev = kmers.device
    valid = as_tensor(valid, torch.bool, dev)
    gids = as_tensor(genome_ids, torch.int64, dev)
    buckets, vals = _candidates(kmers, m)
    vals = torch.where(valid[:, None], vals, INT64_MAX)
    seg = gids[:, None] * m + buckets
    return _segment_min(vals.reshape(-1), seg.reshape(-1),
                        n_genomes * m).reshape(n_genomes, m)


def smh_build_batch_j0(kmers, valid, genome_ids, m, n_genomes, device=None):
    """The j=0-only SuperMinHash pass: exact whenever it is complete.

    The first candidate of item x lands in bucket k_0 = low32(draw_0) &
    (m-1) with value high32(draw_0) < 2^32, and every j >= 1 candidate is
    >= 2^32, so if every bucket of a genome received some j=0 candidate,
    the j=0 minima ARE the exact h_ (the batch analog of the reference's
    a_-bound, bbmh.h:639-670).

    Returns (h, complete): int64 (n_genomes, m) and a bool scalar tensor,
    left on the device; `h` is the exact sketch iff `complete`. A genome
    with no items at all counts as complete (its exact h_ is all U64_MAX),
    so the empty slots of a pack never force the full path."""
    kmers = as_tensor(kmers, torch.int64, device)
    dev = kmers.device
    valid = as_tensor(valid, torch.bool, dev)
    gids = as_tensor(genome_ids, torch.int64, dev)
    draws = wyrand_draws(kmers, 1, dev)[..., 0]  # (T,)
    seg = gids * m + (draws & (m - 1))
    vals = torch.where(valid, _srl(draws, 32), INT64_MAX)
    h = _segment_min(vals, seg, n_genomes * m).reshape(n_genomes, m)
    # unsigned tests: every bucket below 2^32 (j0-hit), or all empty
    lo = (h >= 0) & (h < (1 << 32))
    g_ok = lo.all(1) | (h == U64_MAX).all(1)
    return h, g_ok.all()


def smh_build_batch(kmers, valid, genome_ids, m, n_genomes, device=None):
    """Exact batched SuperMinHash build with the j=0 fast path: one
    one-draw segment-min, a scalar fetch of its completeness flag, and the
    full candidate pass only when some genome has a j=0-empty bucket."""
    kmers = as_tensor(kmers, torch.int64, device)
    dev = kmers.device
    valid = as_tensor(valid, torch.bool, dev)
    gids = as_tensor(genome_ids, torch.int64, dev)
    h, complete = smh_build_batch_j0(kmers, valid, gids, m, n_genomes, dev)
    if bool(complete):
        return h
    return smh_build_batch_full(kmers, valid, gids, m, n_genomes, dev)


def smh_merge_min(h_a, h_b):
    """Element-wise unsigned min merge: combining batches == one
    sequential build."""
    return umin(h_a, h_b)


def smh_update(h, kmers, valid, m, device=None):
    """Fold a new k-mer batch into an existing single-genome h_ vector."""
    kmers = as_tensor(kmers, torch.int64, device)
    zeros = torch.zeros(kmers.shape, dtype=torch.int64, device=kmers.device)
    batch = smh_build_batch_full(kmers, valid, zeros, m, 1, kmers.device)[0]
    return umin(as_tensor(h, torch.int64, kmers.device), batch)
