"""Synthetic sketch banks with the register distribution of real builds.

Each genome gets `items` uniform 64-bit hashes (WangHash of distinct k-mers
is uniform) pushed through the reference's index/rank rule (hll.h:886-899):
index = top p bits, rank = clz(((h << 1) | 1) << (p - 1)) + 1, and a
register max-reduce - the rule of the reference package's bench bank
(bench.py:109-128), re-implemented here in numpy. SMH buckets are uniform
u64, so band fingerprints of unrelated genomes practically never collide.
"""

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

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


def planted_file_banks(n, seed=2048):
    """(regs uint8 (n, 2^14), aux HLLs uint8 (n, 2^8) from the same hashes,
    SMH uint64 (n, 32)) of n genomes of 256-32768 hashes (log-uniform),
    with 64 planted near-duplicate pairs: the sketch files of
    chip_smoke.py phase 4 (N=2048)."""
    rng = np.random.default_rng(seed)
    items = np.exp(rng.uniform(np.log(256), np.log(32768), n)).astype(
        np.int64)
    regs, hll = synthetic_hll_banks(n, items, (14, 8), rng)
    aux = synthetic_aux(n, 32, rng)
    for i in plant_near_duplicates(regs, aux, rng, 64):
        hll[i + 1] = hll[i]
    return regs, hll, aux


def bench_bank(n, items=BENCH_ITEMS, seed=BENCH_SEED):
    """(regs uint8 (n, 2^14), aux uint64 (n, 32), e float64 (n,)) of the
    reference bench's synthetic bank (bench.py:86-149, build_synthetic_bank),
    draw for draw: default_rng(0xBE7C), the registers of 1024 genomes at a
    time, the SMH buckets drawn after every register row, and
    e = trunc(models.bank.host_cards) of the registers. Equal to the bench's
    bank for n below 1024 or a multiple of it (the only sizes it builds);
    no file cache. Another seed draws another bank of the same law."""
    rng = np.random.default_rng(seed)
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


# Rows a seed child draws in genome_file_bank: each chunk has its own
# stream, so the bytes do not depend on the thread count.
GENOME_CHUNK = 4096
# Planted pairs' Jaccard targets: margins on both sides of tau = 0.9.
PLANT_J = (0.80, 1.00)


def draw_regs(lam, m, q, rng):
    """uint8 (len(lam), m) registers, each drawn from register_law(lam) by
    inversion as genome_regs draws them: R = ceil(log2(lam / E)) for E ~
    Exp(1) in f32, clamped to [0, q + 1]. The ceil comes from frexp of the
    correctly rounded quotient (x = f 2^k, f in [0.5, 1): ceil(log2 x) is
    k, or k - 1 where f = 0.5), so no libm log decides a register; an E
    of 0 (x = inf) gives q + 1."""
    x = rng.standard_exponential((len(lam), m), dtype=np.float32)
    with np.errstate(divide="ignore"):
        np.divide(np.asarray(lam, np.float32)[:, None], x, out=x)
    f, k = np.frexp(x)
    k -= f == 0.5
    np.putmask(k, x == np.inf, q + 1)
    np.clip(k, 0, q + 1, out=k)
    return k.astype(np.uint8)


def genome_file_bank(n, seed, planted=256, threads=8, p=14, m=32,
                     items=GENOME_ITEMS):
    """(regs uint8 (n, 2^p), SMH uint64 (n, m), pairs int64 (planted, 2),
    targets float64 (planted,)) of n real-sized genomes with `planted`
    near-duplicate pairs: the bank of experiments/validate_cli_scale.py.

    Row chunks of GENOME_CHUNK draw on `threads` threads, each from its own
    np.random.SeedSequence(seed).spawn child, so the same seed gives the
    same bytes whatever the thread count. A genome's cardinality is
    log-uniform in `items`, its registers draw_regs of it, its buckets
    synthetic_aux's law. Then, from the last child, each planted pair (a,
    b) of distinct rows takes a target J uniform in PLANT_J and a
    cardinality c log-uniform in `items`: a shared part of s = 2cJ / (1 +
    J) hashes and two private parts of s (1 - J) / (2J) each, drawn apart;
    a and b take the register-wise max of the shared part and their own
    private part (true Jaccard J), and each of b's buckets is a's with
    probability J, drawn anew otherwise."""
    q, regs_m = 64 - p, 1 << p
    lo, hi = np.log(items[0]), np.log(items[1])
    n_chunks = -(-n // GENOME_CHUNK)
    kids = np.random.SeedSequence(seed).spawn(n_chunks + 1)
    regs = np.empty((n, regs_m), np.uint8)
    aux = np.empty((n, m), np.uint64)

    def draw(c):
        rng = np.random.default_rng(kids[c])
        s0 = c * GENOME_CHUNK
        rows = min(GENOME_CHUNK, n - s0)
        card = np.exp(rng.uniform(lo, hi, rows))
        regs[s0:s0 + rows] = draw_regs(card / regs_m, regs_m, q, rng)
        aux[s0:s0 + rows] = synthetic_aux(rows, m, rng)

    with ThreadPoolExecutor(max(1, threads)) as pool:
        list(pool.map(draw, range(n_chunks)))
    rng = np.random.default_rng(kids[-1])
    pairs = rng.choice(n, size=2 * planted, replace=False).reshape(
        2, planted).T.astype(np.int64)
    targets = rng.uniform(*PLANT_J, planted)
    card = np.exp(rng.uniform(lo, hi, planted))
    shared = 2.0 * card * targets / (1.0 + targets)
    private = shared * (1.0 - targets) / (2.0 * targets)
    base = draw_regs(shared / regs_m, regs_m, q, rng)
    for side in (0, 1):
        regs[pairs[:, side]] = np.maximum(
            base, draw_regs(private / regs_m, regs_m, q, rng))
    a, b = pairs[:, 0], pairs[:, 1]
    keep = rng.random((planted, m)) < targets[:, None]
    aux[b] = np.where(keep, aux[a], synthetic_aux(planted, m, rng))
    return regs, aux, pairs, targets


# A synthetic FASTA corpus for the build path (chip_smoke.py phase 7,
# experiments/hostmem_split.py).
BASES = np.frombuffer(b"ACGT", np.uint8)


def _fasta_gz(records, rng):
    """gzip (level 1) FASTA bytes of [(name, codes 0..3)]: 80-column lines,
    a lowercase run per ~50 kbp and an N run per ~100 kbp."""
    out = []
    for name, codes in records:
        seq = BASES[codes]
        n = seq.size
        for _ in range(n // 50_000 + 1):
            s0 = int(rng.integers(0, n))
            seq[s0:s0 + int(rng.integers(100, 5000))] |= 0x20
        for _ in range(max(1, n // 100_000)):
            s0 = int(rng.integers(0, n))
            seq[s0:s0 + int(rng.integers(1, 100))] = ord("N")
        full = n // 80
        body = np.empty((full, 81), np.uint8)
        body[:, :80] = seq[:full * 80].reshape(full, 80)
        body[:, 80] = ord("\n")
        out += [b">" + name + b"\n", body.tobytes()]
        if n % 80:
            out += [seq[full * 80:].tobytes(), b"\n"]
    co = zlib.compressobj(1, zlib.DEFLATED, 31)
    return co.compress(b"".join(out)) + co.flush()


def write_fasta_corpus(d, seed, n_base=96, len_range=(5e5, 6e6)):
    """A bacterial-scale corpus under d, made from `seed`: n_base genomes
    of log-uniform chromosome length in len_range plus 0-3 plasmids of
    20-200 kbp; 16 copies of random base genomes at SNP rate 0.001
    (J ~ 0.94 at k=31) and 8 at 0.02 (J ~ 0.37); 4 FASTQ files of one
    40-60 base read (fewer k-mers than 32 SMH buckets). Returns (files,
    near pairs, far pairs, bases), pairs as (base, copy) file indices."""
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(*np.log(len_range), n_base)).astype(np.int64)
    genomes = []
    for n in lens:
        recs = [rng.integers(0, 4, int(n), dtype=np.uint8)]
        recs += [rng.integers(0, 4, int(rng.integers(20_000, 200_001)),
                              dtype=np.uint8)
                 for _ in range(int(rng.integers(0, 4)))]
        genomes.append(recs)
    near, far = [], []
    for j, b in enumerate(rng.choice(n_base, 24, replace=False)):
        rate = 0.001 if j < 16 else 0.02
        recs = []
        for r in genomes[b]:
            r = r.copy()
            hit = np.nonzero(rng.random(r.size) < rate)[0]
            r[hit] = (r[hit] + rng.integers(1, 4, hit.size,
                                            dtype=np.uint8)) % 4
            recs.append(r)
        (near if j < 16 else far).append((int(b), len(genomes)))
        genomes.append(recs)
    files = [os.path.join(d, f"g{i:03d}.fna.gz") for i in range(len(genomes))]

    def write(i):
        recs = [(b"chr%d" % i, genomes[i][0])] + [
            (b"plasmid%d_%d" % (i, k), r)
            for k, r in enumerate(genomes[i][1:], 1)]
        with open(files[i], "wb") as fh:
            fh.write(_fasta_gz(recs, np.random.default_rng([seed, i])))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(len(genomes))))
    for q in range(4):
        read = BASES[rng.integers(0, 4, int(rng.integers(40, 61)))]
        path = os.path.join(d, f"reads{q}.fq")
        with open(path, "wb") as fh:
            fh.write(b"@read%d\n%s\n+\n%s\n" % (q, read.tobytes(),
                                                 b"@" * read.size))
        files.append(path)
    bases = sum(r.size for recs in genomes for r in recs)
    return files, near, far, bases
