"""Confirm-stage throughput. Port of the JAX package's
experiments/confirm_throughput.py.

The exact confirm stage dominates at low-selectivity operating points (the
reference's differential protocol runs at tau=0.01,
run_comparison_experiment.sh:62-70, and the `baseline` criterion confirms
every pair). The default protocol measures, on a random p=14 bank at
tau=-100 (every pair takes the full union-MLE, the worst case):

  host      - the numpy path: vectorized gates, the native fused union
              histograms (numpy's where libfastx does not build) and the
              batched f64 MLE (utils/hostref), on a quarter of the pairs
  device    - ScreenPlan.device_hist_fn: union histograms on the device
              from the resident bank (exact integer counts), the f64 MLE on
              the host

and requires both outputs equal. --reject measures the production-shaped
workload: the bench bank's register distribution (utils/synth) with
planted near-duplicates, one tenth of the pairs duplicates and the rest
random at tau=0.9, with the device reject bound off (tau=-100) and on. With
it on, a pair costs one flag byte and only maybe-pass pairs fetch their
histograms; both outputs must be equal.

Prints one JSON line of pairs/s.

    python -m \
        cuda_selection_criteria_tpu_torch.experiments.confirm_throughput \
        --n 16384 --pairs 1048576 [--reject] [--device cpu]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..utils import hostmem


def random_bank(n, seed=2, p=14):
    """The default protocol's bank: uniform registers 0..27 and sorted
    uniform cardinalities in [1e5, 2e5) (so sorted positions are bank
    rows), and the generator that draws its pairs."""
    from ..models import SketchBank

    rng = np.random.default_rng(seed)
    regs = rng.integers(0, 28, size=(n, 1 << p), dtype=np.uint8)
    cards = np.sort(rng.uniform(1e5, 2e5, n))
    return SketchBank(names=[f"g{i}" for i in range(n)], regs=regs, p=p,
                      cards=np.trunc(cards)), rng


def random_pairs(n, n_pairs, rng):
    """n_pairs uniform (i, k) with i < k < n."""
    ii = rng.integers(0, n - 1, n_pairs)
    kk = ii + 1 + rng.integers(0, n - ii - 1)
    return ii, kk


def reject_bank(n, rng):
    """The bench bank (n genomes of 2048 hashes at p=14) with min(1024,
    n / 4) rows made near-duplicates of their successor: (bank, picks)."""
    from ..models import SketchBank
    from ..utils import synth

    regs = synth.synthetic_regs(n, synth.BENCH_ITEMS, synth.BENCH_P,
                                np.random.default_rng(synth.BENCH_SEED))
    picks = rng.choice(n - 1, size=min(1024, n // 4), replace=False)
    for i in picks:
        regs[i + 1] = regs[i]
        regs[i + 1, rng.integers(0, regs.shape[1], 4)] += 1
    return SketchBank(names=[f"g{i}" for i in range(n)], regs=regs,
                      p=14), picks


def reject_pairs(bank, picks, n_pairs, rng):
    """Sorted-position pairs (lo < hi) of the reject workload: one tenth
    (picks[s], picks[s] + 1) for random slots s, the rest random row
    pairs."""
    n = bank.n
    n_dup = n_pairs // 10
    dup = picks[rng.integers(0, len(picks), n_dup)]
    rand_i, rand_k = random_pairs(n, n_pairs - n_dup, rng)
    ii = np.concatenate([dup, rand_i]).astype(np.int64)
    kk = np.concatenate([dup + 1, rand_k]).astype(np.int64)
    pos = np.empty(n, np.int64)
    pos[bank.sorted_by_cardinality()] = np.arange(n)
    sp = np.stack([pos[ii], pos[kk]])
    return sp.min(0), sp.max(0)


def _timed(fn, n, reps, label):
    """(n / best seconds of `reps` calls after one warm-up, last output)."""
    print(f"# warmup {label}", file=sys.stderr, flush=True)
    fn()
    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        print(f"# {label} rep{r}: {n / dt:.3e}/s", file=sys.stderr,
              flush=True)
        best = min(best, dt)
    return n / best, out


def _plan(bank, tau, device):
    from ..parallel.screened import ScreenPlan
    from ..parallel.selection import SelectionParams

    return ScreenPlan(bank, SelectionParams(tau=tau, criterion="baseline"),
                      ti=512, device=device)


def confirm_rates(bank, ii, kk, device, reps=3, chunk=8192, batch=16384,
                  host_only=False):
    """The default protocol on the sorted-position pairs (ii < kk) of
    `bank`, at tau=-100: ({JSON fields}, host output, device output or
    None). The host rate is taken on the first quarter of the pairs; the
    device-assisted output must equal the host output on all of them."""
    from ..utils.hostref import PairOracle, hist_backend

    order = bank.sorted_by_cardinality()
    regs_s = bank.regs[order]
    e_s = np.trunc(bank.cards[order])
    pairs = list(zip(ii.tolist(), kk.tolist()))
    oracle_host = PairOracle(bank.p, regs_s, e_s, criterion="baseline",
                             tau=-100.0, apply_cb=False)
    host_pairs = pairs[: max(1, len(pairs) // 4)]
    host_rate, _ = _timed(lambda: oracle_host.confirm_pairs(host_pairs),
                          len(host_pairs), reps, "host")
    host_out = oracle_host.confirm_pairs(pairs)
    res = {"n_pairs": len(pairs), "device": str(torch.device(device)),
           "native_hist": hist_backend() == "native",
           "host_confirm_pairs_per_sec": round(host_rate, 1)}
    if host_only:
        res["n_pairs"] = len(host_pairs)
        return res, host_out, None
    plan = _plan(bank, 0.9, device)
    # tau=-100 here too: the reject bound follows the oracle's threshold,
    # not the plan's (PairOracle refuses a bound above its own tau)
    oracle_dev = PairOracle(bank.p, lambda: plan.regs_s, plan.e_s,
                            criterion="baseline", tau=-100.0, apply_cb=False,
                            hist_fn=plan.device_hist_fn(chunk=chunk,
                                                        tau=-100.0))
    dev_rate, dev_out = _timed(
        lambda: oracle_dev.confirm_pairs(pairs, batch=batch), len(pairs),
        reps, "device")
    if dev_out != host_out:
        raise RuntimeError("device-assisted confirm differs from the host's")
    res["device_assisted_confirm_pairs_per_sec"] = round(dev_rate, 1)
    return res, host_out, dev_out


def reject_rates(bank, lo, hi, device, tau=0.9, reps=3, chunk=8192,
                 batch=16384):
    """The reject workload on the sorted-position pairs (lo < hi): the
    device-assisted confirm at `tau` with the reject bound off and on
    ({JSON fields}, output); the two outputs must be equal."""
    from ..utils.hostref import PairOracle

    plan = _plan(bank, tau, device)
    pairs = list(zip(lo.tolist(), hi.tolist()))

    def confirm(hist_fn):
        return PairOracle(bank.p, lambda: plan.regs_s, plan.e_s,
                          criterion="baseline", tau=tau, apply_cb=False,
                          hist_fn=hist_fn).confirm_pairs(pairs, batch=batch)

    off_fn = plan.device_hist_fn(chunk=chunk, tau=-100.0)
    on_fn = plan.device_hist_fn(chunk=chunk, tau=tau)
    rate_off, out_off = _timed(lambda: confirm(off_fn), len(pairs), reps,
                               "reject-off")
    rate_on, out_on = _timed(lambda: confirm(on_fn), len(pairs), reps,
                             "reject-on")
    if out_off != out_on:
        raise RuntimeError("the reject bound changed the confirm output")
    pend, nb = on_fn.dispatch(lo, hi)
    rej = torch.cat([r for _, r in pend]).cpu().numpy()[:nb]
    return {"protocol": "reject_workload", "n_pairs": len(pairs),
            "tau": tau, "device": str(torch.device(device)),
            "reject_fraction": round(float(rej.mean()), 4),
            "pairs_emitted": len(out_on),
            "device_reject_off_pairs_per_sec": round(rate_off, 1),
            "device_reject_on_pairs_per_sec": round(rate_on, 1)}, out_on


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(prog="confirm_throughput",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--pairs", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=8192,
                    help="device histogram chunk (pairs per dispatch)")
    ap.add_argument("--batch", type=int, default=16384,
                    help="oracle adjudication batch (pairs per fetch+MLE)")
    ap.add_argument("--host-only", action="store_true",
                    help="skip the device-assisted mode")
    ap.add_argument("--reject", action="store_true",
                    help="measure the ~90%% reject workload with the device "
                         "reject bound on vs off (bench bank, tau=0.9)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the device "
                         "histograms as CPU torch ops)")
    args = ap.parse_args(argv)

    if args.reject:
        rng = np.random.default_rng(9)
        bank, picks = reject_bank(args.n, rng)
        lo, hi = reject_pairs(bank, picks, args.pairs, rng)
        res, _ = reject_rates(bank, lo, hi, args.device, reps=args.reps,
                              chunk=args.chunk, batch=args.batch)
    else:
        bank, rng = random_bank(args.n)
        ii, kk = random_pairs(args.n, args.pairs, rng)
        res, _, _ = confirm_rates(bank, ii, kk, args.device, reps=args.reps,
                                  chunk=args.chunk, batch=args.batch,
                                  host_only=args.host_only)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
