"""Synthetic sketch banks with the register distribution of real builds.

Each genome gets `items` uniform 64-bit hashes (WangHash of distinct k-mers
is uniform) pushed through the reference's index/rank rule (hll.h:886-899):
index = top p bits, rank = clz(((h << 1) | 1) << (p - 1)) + 1, and a
register max-reduce - the rule of the reference package's bench bank
(bench.py:109-128), re-implemented here in numpy. SMH buckets are uniform
u64, so band fingerprints of unrelated genomes practically never collide.
"""

import numpy as np

from ..models.bank import host_cards

# The reference bench's bank (bench.py:50-60, 86-149): its seed, hashes per
# genome, precision and SMH buckets.
BENCH_SEED = 0xBE7C
BENCH_ITEMS = 2048
BENCH_P = 14
BENCH_M = 32


def synthetic_regs(n, items, p, rng, chunk=1024):
    """uint8 (n, 2^p) registers of n genomes; `items` is the number of
    distinct hashes per genome, one int or an (n,) array."""
    return synthetic_hll_banks(n, items, (p,), rng, chunk)[0]


def synthetic_hll_banks(n, items, ps, rng, chunk=1024):
    """One uint8 (n, 2^p) register bank per precision p in `ps`, all
    reduced from the same hashes of each genome, as the reference builds
    .hll and .hll_{p_aux} from one k-mer stream. The draws are those of
    synthetic_regs, whatever `ps` holds."""
    counts = np.broadcast_to(np.asarray(items, np.int64), (n,))
    banks = [np.zeros((n, 1 << p), np.uint8) for p in ps]
    for g0 in range(0, n, chunk):
        g = min(chunk, n - g0)
        cnt = counts[g0:g0 + g]
        h = rng.integers(0, 1 << 64, size=(g, int(cnt.max())),
                         dtype=np.uint64)
        valid = np.arange(h.shape[1])[None, :] < cnt[:, None]
        for p, regs in zip(ps, banks):
            regs[g0:g0 + g] = _reduce_hashes(h, valid, p)
    return banks


def _reduce_hashes(h, valid, p):
    """uint8 (g, 2^p) registers of the hash rows h (g, c), where `valid`
    marks each row's hashes: index = top p bits, rank = clz of
    ((h << 1) | 1) << (p - 1), plus one, max-reduced per register."""
    g = h.shape[0]
    idx = (h >> np.uint64(64 - p)).astype(np.int64)
    v = ((h << np.uint64(1)) | np.uint64(1)) << np.uint64(p - 1)
    # bit length of v > 0 from the exponent of its top non-zero 32-bit half:
    # a uint32 converts to f64 exactly, so frexp's exponent is its bit length
    hi = (v >> np.uint64(32)).astype(np.uint32)
    top = hi != 0
    _, bl = np.frexp(np.where(top, hi, v.astype(np.uint32)).astype(
        np.float64))
    rank = (65 - 32 * top - bl).astype(np.uint8)  # clz + 1
    rank[~valid] = 0
    flat = np.arange(g)[:, None] * (1 << p) + idx
    sub = np.zeros(g * (1 << p), np.uint8)
    np.maximum.at(sub, flat.ravel(), rank.ravel())
    return sub.reshape(g, 1 << p)


def synthetic_aux(n, m, rng):
    """uint64 (n, m) SMH buckets of unrelated genomes."""
    return rng.integers(0, 1 << 63, size=(n, m), dtype=np.uint64)


def plant_near_duplicates(regs, aux, rng, n_pairs, bumps=4):
    """Make n_pairs genomes near-duplicates of their predecessor, in place:
    row i+1 = row i with `bumps` registers raised by one, and an identical
    aux row (SMH buckets or aux HLL registers), so the aux gate passes them
    like true near-duplicates
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


def bench_bank(n, items=BENCH_ITEMS):
    """(regs uint8 (n, 2^14), aux uint64 (n, 32), e float64 (n,)) of the
    reference bench's synthetic bank (bench.py:86-149, build_synthetic_bank),
    draw for draw: default_rng(0xBE7C), the registers of 1024 genomes at a
    time, the SMH buckets drawn after every register row, and
    e = trunc(models.bank.host_cards) of the registers. Equal to the bench's
    bank for n below 1024 or a multiple of it (the only sizes it builds);
    no file cache."""
    rng = np.random.default_rng(BENCH_SEED)
    regs = synthetic_regs(n, items, BENCH_P, rng)
    aux = synthetic_aux(n, BENCH_M, rng)
    e = np.trunc(host_cards(regs, BENCH_P))
    return regs, aux, e


# A curator's collection of real genomes (GTDB-sized bacterial and archaeal
# assemblies): 2^20 to 2^24 distinct k-mers a genome, log-uniform.
GENOME_ITEMS = (1 << 20, 1 << 24)


def register_law(lam, p):
    """float64 (..., q + 2) probabilities of a register's value 0..q+1
    (q = 64 - p) when Poisson(lam) hashes land in it: P(R <= k) =
    exp(-lam 2^-k) for k <= q, and R <= q + 1 always (Ertl's Poisson
    model, the law the MLE maximises)."""
    q = 64 - p
    lam = np.asarray(lam, np.float64)[..., None]
    cdf = np.exp(-lam * np.ldexp(1.0, -np.arange(q + 1)))
    return np.concatenate([cdf[..., :1], np.diff(cdf, axis=-1),
                           1.0 - cdf[..., -1:]], axis=-1)


def genome_hists(n, p, rng, items=GENOME_ITEMS):
    """int32 (n, 64) register histograms of n real-sized genomes at p (the
    layout of ops/screen.row_hist: bins 0..q+1, zeros after): each row a
    multinomial of the 2^p registers over register_law(cardinality / 2^p)
    for a cardinality drawn log-uniform in `items`. Above about 2^p * 30
    hashes no register is zero and the rows' secant loops run longer than
    the bench bank's (2048 hashes a genome)."""
    m = 1 << p
    card = np.exp(rng.uniform(np.log(items[0]), np.log(items[1]), n))
    probs = register_law(card / m, p)
    out = np.zeros((n, 64), np.int32)
    out[:, :probs.shape[1]] = rng.multinomial(m, probs)
    return out


def genome_regs(torch, n, p, seed, device, items=GENOME_ITEMS,
                chunk=4096):
    """uint8 (n, 2^p) registers of n real-sized genomes, drawn on `device`
    from a torch generator seeded with `seed`: a cardinality log-uniform in
    `items` a row, then each register independently from register_law by
    inversion, R = ceil(log2(lam / E)) for E ~ Exp(1), clamped to
    [0, q + 1]. Made on the device: a 2 GiB bank is 2^31 draws."""
    q, m = 64 - p, 1 << p
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, m), dtype=torch.uint8, device=device)
    lo, hi = np.log(items[0]), np.log(items[1])
    for s in range(0, n, chunk):
        rows = min(chunk, n - s)
        u = torch.rand((rows, 1), generator=gen, device=device,
                       dtype=torch.float64)
        lam = torch.exp(lo + (hi - lo) * u) / m
        e = torch.empty((rows, m), device=device).exponential_(
            generator=gen)
        r = torch.ceil(torch.log2(lam.float() / e)).clamp_(0, q + 1)
        out[s:s + rows] = r.to(torch.uint8)
    return out
