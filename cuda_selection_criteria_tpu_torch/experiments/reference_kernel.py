"""The reference's own GPU selection kernel on this card: kernel_CBsmh
with hll_union_card (experiments/reference_kernel.cu, written as the
reference wrote it), held to the JAX package's ORIGINAL estimator, so the
port's vs_baseline has a measured reference beside its copy-rate bound.

    python -m cuda_selection_criteria_tpu_torch.experiments.reference_kernel \\
        [--n 16384] [--seed 48764]

Needs one CUDA card: without one it raises, and nothing falls back to the
plain version. Builds reference_kernel.cu with nvcc into the package's
build directory, then on the bench bank (utils/synth.bench_bank: p = 14,
SMH m = 32, smh_a at tau 0.9) prints one JSON line:

  ref_gated_pairs_per_sec  the whole triangle as the reference runs it
                           (the smh_a gate, the aux as drawn: nearly every
                           pair stops at the gate), the launch alone
  ref_union_pairs_per_sec  the same kernel on the same registers with every
                           aux row equal to row 0, so every pair takes
                           hll_union_card: the rate that bench.py's
                           baseline bounds; timed over the pair list's
                           first rows, enough for a launch of at least 1 s
                           (ref_union_prefix_pairs), and over the whole
                           triangle where one launch takes under 60 s,
                           then over windows of the
                           prefix's size at the start, middle and end of
                           the pair list (position against time)
  *_card                   the SM clock, power draw and temperature
                           (nvidia-smi, [min, median, max]) sampled while
                           a timed union launch runs
  *_launch_ms              CUDA events around the launch after one untimed
                           launch (the reference's timer stops before the
                           card is done; this one waits for it)
  *_wall_secs              selection_cuda's path from the host bank to the
                           sorted lines: sort by cardinality and flatten,
                           the pair list, the upload, the launch, the fetch
                           (with the stages' seconds)
  card_baseline            utils/hopper.card_baseline, the union rate's
                           bound (2 x 16 KiB a pair at the card's copy
                           rate), and the share ref_union / card_baseline
  port_headline_pairs_per_sec, port_vs_reference_kernel
                           the port's experiments/bench.measure headline at
                           the same N in the same process, before the
                           reference's launches (and again after them:
                           port_headline_after_pairs_per_sec), and
                           headline / ref_union_pairs_per_sec
  peak_bytes               torch.cuda.max_memory_allocated of each mode

reference_pairs is the kernel's wrapper; reference_pairs_plain its plain
PyTorch version (the tests' and chip_smoke.py's comparison). Nothing on
the port's user path calls either: the kernel is a measured baseline.
"""

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _build, criteria, estimators
from ..utils import hopper, hostmem, synth
from ..utils.device import resolve

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "reference_kernel.cu")
P = 14        # hll_union_card's precision, fixed in the reference
BLOCK = 256   # threads a CTA: the reference experiments' default -b
TAU = 0.9
N_GENOMES = 16384  # the bench bank's N
GATE_CHUNK = 1 << 20   # pairs a gate step of the plain version
UNION_CHUNK = 2048     # pairs a union step of the plain version
SIZING_PAIRS = 1 << 20  # the union mode's first launch, sizing the prefix
MIN_LAUNCH_SECS = 1.0   # the union prefix's least launch time
GATED_REPS = 3          # timed launches of the gated triangle
SAMPLE_SECS = 0.5       # nvidia-smi samples' spacing during a union launch

_lib = []


def build():
    """(library path, build seconds, nvcc log) of reference_kernel.cu, a
    standalone source, in the package's build directory."""
    return _build.build_probe(SOURCE, None, "reference_kernel")


def library():
    """The kernel's library, built at the first call and kept."""
    if not _lib:
        lib = ctypes.CDLL(build()[0])
        V, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.csc_reference_cbsmh.argtypes = [
            V, V, V, V, LL, ctypes.c_double, I, I, I, V, V, LL, I, V]
        lib.csc_reference_cbsmh.restype = I
        _lib.append(lib)
    return _lib[0]


def pair_list(n):
    """int32 (n(n-1)/2, 2): every (i, k) with i < k < n, row by row, the
    list selection_cuda.cpp:146-150 materializes (np.triu_indices(n, 1))."""
    counts = np.arange(n - 1, -1, -1, dtype=np.int64)
    starts = np.cumsum(counts) - counts
    out = np.empty((int(counts.sum()), 2), np.int32)
    out[:, 0] = np.repeat(np.arange(n, dtype=np.int32), counts)
    out[:, 1] = np.arange(len(out), dtype=np.int64) - np.repeat(
        starts - np.arange(n) - 1, counts)
    return out


def union_cards(regs, a, b):
    """f64 ORIGINAL estimates of the unions of rows a and b of regs (uint8
    (N, 2^14)): estimators.hll_histogram of the register-wise max, then
    estimators.original_estimate."""
    union = torch.maximum(regs[a], regs[b])
    return estimators.original_estimate(estimators.hll_histogram(union, P), P)


def reference_pairs_plain(regs, aux, cards, tau, n_rows, n_bands, pairs,
                          dtype=torch.float32):
    """Plain PyTorch version of the kernel over the listed pairs, on the
    tensors' device: regs uint8 (N, 2^14), aux int64 (N, m) SMH buckets,
    cards f64 (N,), pairs integer (P, 2) row indices. The smh_a gate of
    criteria.smh_a_mask over each listed pair; for the pairs that pass,
    union_cards and J = (c_i + c_k - t) / t in f64; a J that is not finite
    or is below criteria.effective_tau(tau) rejected. In GATE_CHUNK and
    UNION_CHUNK steps, so N = 2048 fits in host memory. Returns (i, k,
    sim) of the kept pairs in list order: int64 rows as listed and the
    sims cast to `dtype` (float32, as the kernel stores them)."""
    tau = float(criteria.effective_tau(tau))
    width = n_rows * n_bands
    out = ([], [], [])
    for g0 in range(0, len(pairs), GATE_CHUNK):
        chunk = pairs[g0:g0 + GATE_CHUNK].to(torch.int64)
        a, b = chunk[:, 0], chunk[:, 1]
        eq = aux[a, :width] == aux[b, :width]
        gate = eq.view(-1, n_bands, n_rows).all(-1).any(-1)
        a, b = a[gate], b[gate]
        for u0 in range(0, len(a), UNION_CHUNK):
            ua, ub = a[u0:u0 + UNION_CHUNK], b[u0:u0 + UNION_CHUNK]
            t = union_cards(regs, ua, ub)
            sim = (cards[ua] + cards[ub] - t) / t
            keep = torch.isfinite(sim) & (sim >= tau)
            for acc, x in zip(out, (ua[keep], ub[keep], sim[keep].to(dtype))):
                acc.append(x)
    if not out[0]:
        dev = regs.device
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=dtype, device=dev))
    return tuple(torch.cat(x) for x in out)


def sorted_bank(regs, aux, cards):
    """(order, regs, aux, cards) sorted by cardinality with a stable
    argsort, as the plan sorts and selection_cuda.cpp:95-116 does."""
    order = np.argsort(cards, kind="stable")
    return (order, np.ascontiguousarray(regs[order]),
            np.ascontiguousarray(aux[order]), np.ascontiguousarray(
                cards[order], dtype=np.float64))


def genome_lines(order, x, y, sim):
    """(i, k, sim) numpy of results (x, y, sim) at sorted positions (torch,
    any device), in original genome ids with i < k, sorted by (i, k): the
    kernel's append order is nondeterministic."""
    d_order = torch.from_numpy(order).to(x.device)
    a, b = d_order[x.to(torch.int64)], d_order[y.to(torch.int64)]
    i, k = torch.minimum(a, b), torch.maximum(a, b)
    perm = torch.argsort(i * len(order) + k)
    return (i[perm].to(torch.int32).cpu().numpy(),
            k[perm].to(torch.int32).cpu().numpy(), sim[perm].cpu().numpy())


def plain_lines(regs, aux, cards, tau, device=None, n_pairs=None):
    """reference_pairs_plain on reference_pairs' inputs (the bank sorted by
    cardinality, the first n_pairs of its pair list, the bands of
    criteria.smh_band_params) on `device`, as sorted genome lines."""
    dev = resolve(device)
    order, regs_s, aux_s, cards_s = sorted_bank(regs, aux, cards)
    n_rows, n_bands = criteria.smh_band_params(aux.shape[1], tau)
    pairs = torch.from_numpy(pair_list(len(order))[:n_pairs]).to(dev)
    i, k, sim = reference_pairs_plain(
        torch.from_numpy(regs_s).to(dev),
        torch.from_numpy(aux_s.view(np.int64)).to(dev),
        torch.from_numpy(cards_s).to(dev), tau, n_rows, n_bands, pairs)
    return genome_lines(order, i, k, sim)


class Prepared(NamedTuple):
    """The kernel's inputs and outputs resident on the card."""
    order: np.ndarray
    d_regs: torch.Tensor    # uint8 (N, 2^14), sorted by cardinality
    d_aux: torch.Tensor     # int64 (N, m), the same order
    d_cards: torch.Tensor   # f64 (N,)
    d_pairs: torch.Tensor   # int32 (n_pairs, 2)
    out: torch.Tensor       # int32 (capacity, 3): the Results
    count: torch.Tensor     # int64 (1,): the device counter
    tau: float              # criteria.effective_tau
    n_rows: int
    n_bands: int


def _cuda(device):
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"reference_kernel: the kernel runs on a CUDA card "
                         f"only, not on {dev} (its plain version is "
                         "reference_pairs_plain)")
    if not torch.cuda.is_available():
        raise RuntimeError("reference_kernel: no CUDA card")
    return dev


def prepare(regs, aux, cards, tau, device=None, n_pairs=None, capacity=None,
            stages=None):
    """The host path of selection_cuda.cpp:95-170: the bank sorted by
    cardinality and flattened, the pair list (its first n_pairs), the
    upload, and an output of `capacity` Results (default one a pair, as
    the reference allocates it). regs uint8 (N, 2^14), aux uint64 (N, m),
    cards f64 (N,) numpy. stages: a dict that gets each step's seconds."""
    if regs.dtype != np.uint8 or regs.ndim != 2 or regs.shape[1] != 1 << P:
        raise ValueError(f"reference_kernel: uint8 rows of {1 << P} "
                         f"registers (p = {P}), not {regs.dtype} "
                         f"{regs.shape}")
    if aux.dtype != np.uint64 or aux.ndim != 2 or \
            not len(regs) == len(aux) == len(cards) < 1 << 31:
        raise ValueError("reference_kernel: aux must be uint64 (N, m) and "
                         "cards (N,), with N below 2^31")
    dev = _cuda(device)
    stages = {} if stages is None else stages
    t0 = time.perf_counter()
    order, regs_s, aux_s, cards_s = sorted_bank(regs, aux, cards)
    t1 = time.perf_counter()
    pairs = pair_list(len(order))[:n_pairs]
    t2 = time.perf_counter()
    n_rows, n_bands = criteria.smh_band_params(aux.shape[1], tau)
    prep = Prepared(
        order=order, d_regs=torch.from_numpy(regs_s).to(dev),
        d_aux=torch.from_numpy(aux_s.view(np.int64)).to(dev),
        d_cards=torch.from_numpy(cards_s).to(dev),
        d_pairs=torch.from_numpy(pairs).to(dev),
        out=torch.empty((len(pairs) if capacity is None else capacity, 3),
                        dtype=torch.int32, device=dev),
        count=torch.zeros(1, dtype=torch.int64, device=dev),
        tau=float(criteria.effective_tau(tau)), n_rows=n_rows,
        n_bands=n_bands)
    torch.cuda.synchronize(dev)
    stages.update(flatten=t1 - t0, pair_list=t2 - t1,
                  upload=time.perf_counter() - t2)
    return prep


def launch(prep, lo=0, hi=None):
    """One kernel_CBsmh launch over pairs [lo, hi) of the prepared list,
    on the current stream: the counter cleared, then the results appended
    from slot 0. Raises if the launch failed."""
    n = len(prep.d_pairs)
    hi = n if hi is None else min(hi, n)
    n_pairs = max(hi - lo, 0)
    if (n_pairs + BLOCK - 1) // BLOCK >= 1 << 31:
        raise ValueError("reference_kernel: a grid of 2^31 CTAs or more")
    dev = prep.d_pairs.device
    with torch.cuda.device(dev):
        err = library().csc_reference_cbsmh(
            prep.d_regs.data_ptr(), prep.d_aux.data_ptr(),
            prep.d_cards.data_ptr(), prep.d_pairs.data_ptr() + 8 * lo,
            n_pairs, prep.tau, prep.d_aux.shape[1], prep.n_rows,
            prep.n_bands, prep.out.data_ptr(), prep.count.data_ptr(),
            len(prep.out), BLOCK, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel_CBsmh launch failed: cudaError_t {err}")
    launch.launches += 1


launch.launches = 0


def fetch(prep):
    """The count, then the results of the last launch as sorted genome
    lines (genome_lines). Raises when more results were counted than the
    output holds: none is dropped in silence."""
    count = int(prep.count.item())
    if count > len(prep.out):
        raise RuntimeError(f"reference_kernel: {count} results counted, the "
                           f"output holds {len(prep.out)}")
    res = prep.out[:count]
    return genome_lines(prep.order, res[:, 0], res[:, 1],
                        res[:, 2].view(torch.float32))


def reference_pairs(regs, aux, cards, tau, device=None, n_pairs=None,
                    stages=None):
    """The kernel's wrapper: prepare, one launch, fetch. Returns (i, k,
    sim) numpy in original genome ids (i < k), sorted; on a device that is
    not CUDA it raises. n_pairs: the first pairs of the list only.
    stages: a dict that gets each step's seconds."""
    stages = {} if stages is None else stages
    prep = prepare(regs, aux, cards, tau, device, n_pairs, stages=stages)
    t0 = time.perf_counter()
    launch(prep)
    torch.cuda.synchronize(prep.d_pairs.device)
    t1 = time.perf_counter()
    lines = fetch(prep)
    stages.update(launch=t1 - t0, fetch=time.perf_counter() - t1)
    return lines


def launch_ms(prep, lo, hi, reps=1):
    """Milliseconds a launch over pairs [lo, hi): CUDA events around reps
    launches, after one untimed launch, the card waited for."""
    launch(prep, lo, hi)
    torch.cuda.synchronize(prep.d_pairs.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch(prep, lo, hi)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_sample():
    """[SM clock MHz, power draw W, temperature C] of the first card now,
    from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()[0]
    return [float(x) for x in out.split(",")]


def sampled_launch_ms(prep, lo, hi):
    """(ms, card) of one launch over pairs [lo, hi), CUDA events around
    it, with card_sample taken every SAMPLE_SECS while it runs: card
    is {"sm_mhz", "power_w", "temp_c"}: each [min, median, max] over the
    samples, and "samples"."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch(prep, lo, hi)
    end.record()
    samples = [card_sample()]
    while not end.query():
        time.sleep(SAMPLE_SECS)
        samples.append(card_sample())
    end.synchronize()
    cols = np.array(samples).T
    card = {key: [float(c.min()), float(np.median(c)), float(c.max())]
            for key, c in zip(("sm_mhz", "power_w", "temp_c"), cols)}
    card["samples"] = len(samples)
    return start.elapsed_time(end), card


def _wall(regs, aux, cards, tau, dev, n_pairs):
    stages = {}
    t0 = time.perf_counter()
    i, _, _ = reference_pairs(regs, aux, cards, tau, dev, n_pairs, stages)
    wall = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return wall, stages, len(i)


def rates(regs, aux, cards, tau=TAU, device=None, max_triangle_secs=60.0):
    """The kernel's two rates on one bank (see the module's docstring):
    the gated mode over the whole triangle, and the union mode (every aux
    row equal to row 0) over a prefix of at least MIN_LAUNCH_SECS a launch
    (its timed launch sampled by card_sample) and, where one launch is
    expected under max_triangle_secs, over the whole triangle (sampled),
    then over windows of the prefix's size at the start, middle and end
    of the pair list; each mode with its wall and peak device memory.
    Returns a dict."""
    dev = _cuda(device)
    n = len(regs)
    total = n * (n - 1) // 2
    out = {"n_genomes": n, "pairs": total, "block": BLOCK, "tau": tau}

    torch.cuda.reset_peak_memory_stats(dev)
    prep = prepare(regs, aux, cards, tau, dev)
    out.update(n_rows=prep.n_rows, n_bands=prep.n_bands)
    ms = launch_ms(prep, 0, total, GATED_REPS)
    del prep
    torch.cuda.empty_cache()
    wall, stages, found = _wall(regs, aux, cards, tau, dev, None)
    out.update(ref_gated_launch_ms=ms,
               ref_gated_pairs_per_sec=total / (ms * 1e-3),
               ref_gated_wall_secs=wall, ref_gated_stages=stages,
               ref_gated_results=found)
    peak = {"gated": torch.cuda.max_memory_allocated(dev)}

    torch.cuda.reset_peak_memory_stats(dev)
    aux_eq = np.broadcast_to(aux[:1], aux.shape)
    prep = prepare(regs, aux_eq, cards, tau, dev)
    prefix = min(SIZING_PAIRS, total)
    ms = launch_ms(prep, 0, prefix)
    while ms < 1e3 * MIN_LAUNCH_SECS and prefix < total:
        # grow the prefix past the target from the last launch's rate
        prefix = min(total, math.ceil(
            1.25 * MIN_LAUNCH_SECS * prefix / (ms * 1e-3)))
        ms = launch_ms(prep, 0, prefix)
    ms, card = sampled_launch_ms(prep, 0, prefix)
    rate = prefix / (ms * 1e-3)
    out.update(ref_union_prefix_pairs=prefix, ref_union_prefix_launch_ms=ms,
               ref_union_pairs_per_sec=rate, ref_union_prefix_card=card)
    tri_ms = tri_card = None
    windows = {}
    if total / rate < max_triangle_secs:
        tri_ms, tri_card = sampled_launch_ms(prep, 0, total)
        for label, lo in (("start", 0), ("middle", (total - prefix) // 2),
                          ("end", total - prefix)):
            w_ms, w_card = sampled_launch_ms(prep, lo, lo + prefix)
            windows[label] = dict(pairs_per_sec=prefix / (w_ms * 1e-3),
                                  launch_ms=w_ms, card=w_card)
    out.update(ref_union_triangle_launch_ms=tri_ms,
               ref_union_triangle_pairs_per_sec=(
                   None if tri_ms is None else total / (tri_ms * 1e-3)),
               ref_union_triangle_card=tri_card,
               ref_union_windows=windows)
    del prep
    torch.cuda.empty_cache()
    wall_pairs = total if tri_ms is not None else prefix
    wall, stages, found = _wall(regs, aux_eq, cards, tau, dev, wall_pairs)
    out.update(ref_union_wall_pairs=wall_pairs, ref_union_wall_secs=wall,
               ref_union_stages=stages, ref_union_results=found)
    peak["union"] = torch.cuda.max_memory_allocated(dev)
    out["peak_bytes"] = peak
    baseline = hopper.card_baseline(dev, P)
    out.update(card_baseline=baseline,
               ref_union_share_of_baseline=rate / baseline)
    return out


def run(n=N_GENOMES, seed=synth.BENCH_SEED, device=None):
    """The port's bench.measure headline on the N-genome bench bank drawn
    from `seed`, then rates on the same bank, then the headline again, all
    in one process, each headline with a card_sample before it; the ratio
    of the first headline (taken before the reference's launches warm the
    card) to ref_union_pairs_per_sec, and the card's line. A dict."""
    from . import bench

    dev = _cuda(device)
    t0 = time.perf_counter()
    regs, aux, e = synth.bench_bank(n, seed=seed)
    bank_secs = time.perf_counter() - t0

    def headline():
        sample = card_sample()
        rate = bench.measure(n, 3, device=dev, bank=(regs, aux, e))[0]
        torch.cuda.empty_cache()
        return rate, sample

    before, card_before = headline()
    out = rates(regs, aux, e.astype(np.float64), TAU, dev)
    after, card_after = headline()
    out.update(seed=seed, bank_secs=bank_secs,
               port_headline_pairs_per_sec=before,
               port_headline_card=card_before,
               port_headline_after_pairs_per_sec=after,
               port_headline_after_card=card_after,
               port_vs_reference_kernel=before
               / out["ref_union_pairs_per_sec"],
               card=hopper.card_line(),
               device=torch.cuda.get_device_name(dev))
    return out


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="reference_kernel", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=N_GENOMES)
    ap.add_argument("--seed", type=int, default=synth.BENCH_SEED)
    args = ap.parse_args(argv)
    _cuda(None)
    path, secs, log = build()
    print(f"built {os.path.basename(path)} in {secs:.2f} s", flush=True)
    if log.strip():
        print(log.strip(), flush=True)
    print(json.dumps(run(args.n, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
