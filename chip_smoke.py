#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA card: builds the CUDA
kernels from this checkout, holds each against its plain PyTorch version,
runs the selection CLI end to end and drives the main paths at the
reference bench's bank size.

    python3 chip_smoke.py            # needs one CUDA card; about 6 minutes

Phases (any failure exits non-zero, without the final result line):
  1. device   - card name and power limit, torch / CUDA / nvcc versions
  2. build    - nvcc builds every csrc/*.cu for sm_90a, all at once
  3. kernel   - K1 vs its plain version, bit-equal hits and counts: p=8
                (ti=64, every gate combination, with and without zero
                registers, n_real < n, a truncated value list) and p=14
                (ti=1024) on a bank of the real register distribution;
                K1 and plain times at p=14. K2 vs its plain version,
                bit-equal S and Z: p_aux = 5, 6, 8 (ti=64, tj=64 and 128,
                a separate column bank, with and without zeros, a
                truncated value list) and p_aux=8, ti=1024 on the first 64
                tiles of the hll bench bank; K2 and plain times there
  4. cli      - planted .hll/.smh32/.hll_8 files for N=2048 genomes; the
                selection CLI's lines for smh_a, cb, baseline, hll_a and
                hll_an must equal the exact host reference's
  5. main     - select_pairs(smh_a, tau=0.9) on N=16384 genomes at p=14
                (256 MiB of registers on the card) with planted
                near-duplicates: every planted pair the exact oracle passes
                is emitted, every emitted pair is oracle-confirmed with the
                identical Jaccard, and K1 was launched; stage walls and the
                screen's pairs/s over the full triangle
  6. hll      - select_pairs(hll_a) and (hll_an), tau=0.9, on N=16384
                genomes at p=14 with aux HLLs at p_aux=8 from the same
                hashes, planted near-duplicates: the checks of phase 5, K1
                and K2 launched; stage walls, peak device memory and the
                hll screen's (K1 + K2 + aux compare) pairs/s over the full
                triangle

The last two lines are a JSON record of the kernels and the result line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "cuda_selection_criteria_tpu_torch"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "screen_fused": (f"{PKG}/csrc/screen_fused.cu",
                     "cuda_selection_criteria_tpu/ops/screen.py:338"),
    "weighted_cdf_sum": (f"{PKG}/csrc/weighted_cdf_sum.cu",
                         "cuda_selection_criteria_tpu/ops/screen.py:99"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of fn on the card (CUDA events, after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(torch, screen, args, kw):
    """Launch K1 and its plain version on the same card tensors; return the
    max |difference| over hits and counts (must be 0)."""
    got = screen.screen_hits_fused(*args, **kw)
    want = screen._screen_hits_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype, "shape/dtype")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()))
    return err, int(got[1].sum())


def phase_kernel_p8(torch, screen, screened, dev):
    p, ti, n = 8, 64, 192
    rows = torch.tensor([0, 0, 1, 2], dtype=torch.int32, device=dev)
    cols = torch.tensor([0, 2, 1, 2], dtype=torch.int32, device=dev)
    worst = 0
    cases = [(cb, smh, lo, 11) for cb in (True, False)
             for smh in (True, False) for lo in (0, 2)]
    cases.append((True, False, 0, 26))  # truncated value list
    for use_cb, use_smh, lo, hi in cases:
        rng = np.random.default_rng(31 + use_cb + 2 * use_smh + lo + hi)
        regs = rng.integers(lo, hi, size=(n, 1 << p), dtype=np.uint8)
        e = np.sort(rng.uniform(0, 5000, n)).astype(np.float32)
        e[:3] = 0.0
        aux = rng.integers(0, 1 << 63, size=(n, 16), dtype=np.uint64)
        aux[1::5] = aux[0]
        fp = screened.band_fingerprints_np(aux, 4, 4)
        vals = screen.bank_values(regs)
        if hi == 26:
            vals = screen.truncate_values(vals, 40.0, p)
        args = [torch.from_numpy(x).to(dev) for x in (regs,)] + [
            rows, cols] + [torch.from_numpy(x).to(dev) for x in (e, fp)]
        kw = dict(n_real=n - 5, tau_scr=0.4, tau_cb=0.35, p=p, values=vals,
                  ti=ti, n_bands=4, use_cb=use_cb, use_smh=use_smh)
        err, hits = kernel_vs_plain(torch, screen, args, kw)
        print(f"  p=8 ti=64 cb={use_cb} smh={use_smh} zeros={lo == 0} "
              f"bins={len(vals) - 1}: hits={hits} max_abs_err={err}")
        check(err == 0, f"p=8 kernel != plain (cb={use_cb}, smh={use_smh})")
        worst = max(worst, err)
    return worst


def k2_vs_plain(torch, screen, args, kw):
    """Launch K2 and its plain version on the same card tensors; return
    the max |difference| over S and Z (must be 0)."""
    got = screen.screen_s_z(*args, **kw)
    want = screen._screen_s_z_plain(*args, **kw)
    torch.cuda.synchronize()
    check((got[1] is None) == (want[1] is None), "Z presence")
    err = 0.0
    for g, w in zip(got, want):
        if g is not None:
            check(g.shape == w.shape and g.dtype == w.dtype, "shape/dtype")
            err = max(err, float((g - w).abs().max()))
    return err


def phase_k2_small(torch, screen, dev):
    worst = 0.0
    for p in (5, 6, 8):
        for lo, hi, sep_cols, tj in ((0, 13, False, 64), (3, 15, False, 64),
                                     (0, 13, True, 128), (2, 14, True, 64),
                                     (0, 26, False, 128)):
            rng = np.random.default_rng(100 * p + lo + hi + tj)
            regs = rng.integers(lo, hi, size=(256, 1 << p), dtype=np.uint8)
            cols = (rng.integers(lo, hi, size=(384, 1 << p), dtype=np.uint8)
                    if sep_cols else None)
            vals = screen.bank_values(
                regs if cols is None else np.concatenate([regs, cols]))
            if hi == 26:
                vals = screen.truncate_values(vals, 40.0, p)
            rows = torch.tensor([0, 2, 1, 3, 2], dtype=torch.int32,
                                device=dev)
            ctl = torch.tensor([0, 1, 0, 2 if sep_cols else 1, 0],
                               dtype=torch.int32, device=dev)
            kw = dict(p=p, values=vals, ti=64, tj=tj, regs_cols=(
                None if cols is None else torch.from_numpy(cols).to(dev)))
            err = k2_vs_plain(torch, screen, [torch.from_numpy(regs).to(dev),
                                              rows, ctl], kw)
            print(f"  K2 p={p} ti=64 tj={tj} regs_cols={sep_cols} "
                  f"zeros={vals[0] == 0} bins={len(vals) - 1}: "
                  f"max_abs_err={err}")
            check(err == 0, f"K2 p={p} kernel != plain")
            worst = max(worst, err)
    return worst


def bench_bank(models, synth, n, rng, n_dups):
    """The reference bench's headline bank (bench.py:86-149): n genomes of
    2048 hashes at p=14, m=32 uniform SMH buckets, plus planted pairs."""
    regs = synth.synthetic_regs(n, 2048, 14, rng)
    aux = synth.synthetic_aux(n, 32, rng)
    picks = synth.plant_near_duplicates(regs, aux, rng, n_dups)
    bank = models.SketchBank(names=[f"g{i:05d}" for i in range(n)],
                             regs=regs, p=14, aux_kind="smh", aux=aux,
                             aux_param=32)
    return bank, picks


def hll_bench_bank(models, synth, n, rng, n_dups):
    """The bench bank's sizes with an aux HLL at p_aux=8 (aux_bytes 256)
    reduced from the same hashes as the p=14 primary, plus planted pairs."""
    regs, aux = synth.synthetic_hll_banks(n, 2048, (14, 8), rng)
    picks = synth.plant_near_duplicates(regs, aux, rng, n_dups)
    bank = models.SketchBank(names=[f"h{i:05d}" for i in range(n)],
                             regs=regs, p=14, aux_kind="hll", aux=aux,
                             aux_param=8)
    return bank, picks


def verify_pairs(hostref, bank, picks, out, crit):
    """Every emitted pair is oracle-confirmed with the identical Jaccard;
    every planted pair the exact oracle passes is emitted. Returns the
    number of planted pairs the oracle passes."""
    order = bank.sorted_by_cardinality()
    pos = np.empty_like(order)
    pos[order] = np.arange(len(order))
    oracle = hostref.PairOracle(
        bank.p, bank.regs[order], np.trunc(bank.cards[order]),
        aux=bank.aux[order], aux_param=bank.aux_param, criterion=crit,
        tau=0.9)
    name_pos = {name: pos[i] for i, name in enumerate(bank.names)}
    emitted = {}
    for a, b, j in out:
        sel, j_exact = oracle.evaluate(name_pos[a], name_pos[b])
        check(sel and j == j_exact, f"emitted pair {a} {b} not confirmed")
        emitted[(a, b)] = j
    planted_pass = 0
    for i in picks:
        lo, hi = sorted((pos[i], pos[i + 1]))
        if oracle.evaluate(lo, hi)[0]:
            planted_pass += 1
            check((bank.names[order[lo]], bank.names[order[hi]]) in emitted,
                  f"planted pair {i} passes the oracle but was not emitted")
    print(f"  planted pairs passing the exact oracle: {planted_pass} of "
          f"{len(picks)}, all emitted; {len(out)} emitted, all confirmed")
    check(planted_pass > 0, "no planted pair passes the oracle")
    return planted_pass


def run_main_path(torch, screen, select_pairs, bank, params, dev, card):
    """One select_pairs run on the card with the launch counts set to 0
    just before it: (pairs, stats, {kernel: launches})."""
    screen.screen_hits_fused.launches = 0
    screen.screen_s_z.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    out = select_pairs(bank, params, device=dev, stats=stats)
    wall = time.perf_counter() - t0
    launches = {"screen_fused": screen.screen_hits_fused.launches,
                "weighted_cdf_sum": screen.screen_s_z.launches}
    print(f"  [{card}] select_pairs -c {params.criterion} wall {wall:.3f} s: "
          f"plan {stats['plan_secs']:.3f} s, schedule "
          f"{stats['schedule_secs']:.4f} s, prune {stats['prune_secs']:.3f} "
          f"s, screen {stats['screen_secs']:.3f} s, confirm "
          f"{stats['confirm_secs']:.3f} s; tiles {stats['tiles_scheduled']} "
          f"scheduled / {stats['tiles_live']} live, {stats['candidates']} "
          f"candidates, {len(out)} pairs, K1 launches "
          f"{launches['screen_fused']}, K2 launches "
          f"{launches['weighted_cdf_sum']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return out, launches


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from cuda_selection_criteria_tpu_torch import models
    from cuda_selection_criteria_tpu_torch.cli import selection as cli
    from cuda_selection_criteria_tpu_torch.ops import _build, screen
    from cuda_selection_criteria_tpu_torch.parallel import (scheduler,
                                                            screened)
    from cuda_selection_criteria_tpu_torch.parallel.selection import (
        SelectionParams, format_results, select_pairs)
    from cuda_selection_criteria_tpu_torch.utils import formats, hostref
    from cuda_selection_criteria_tpu_torch.utils import synth

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain: exact f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    print("== phase 1: device", flush=True)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} cards {torch.cuda.device_count()} "
          f"({torch.cuda.get_device_name(0)})")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(nvcc.strip().splitlines()[-1])

    print("== phase 2: build", flush=True)
    for name, (path, build_secs, log) in _build.build().items():
        print(log.strip())
        print(f"built {os.path.relpath(path, HERE)} in {build_secs:.2f} s")
        _build.library(name)

    print("== phase 3: kernel vs plain", flush=True)
    max_err = phase_kernel_p8(torch, screen, screened, dev)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0xBE7C)
    bank, picks = bench_bank(models, synth, 16384, rng, 300)
    print(f"  bench bank N=16384 p=14 m=32 with {len(picks)} planted pairs "
          f"made in {time.perf_counter() - t0:.1f} s (host)")
    params = SelectionParams(tau=0.9, criterion="smh_a")
    plan = screened.ScreenPlan(bank, params, 1024, device=dev)
    tri_r, tri_c = scheduler.triangle_block_ids(plan.e_s, plan.tau, 1024,
                                                use_cb_skip=False)
    chunk = screened.auto_chunk(1024)
    r64 = torch.from_numpy(tri_r[:chunk].astype(np.int32)).to(dev)
    c64 = torch.from_numpy(tri_c[:chunk].astype(np.int32)).to(dev)
    args = [plan.d_regs, r64, c64, plan.d_e, plan.d_fp]
    kw = dict(n_real=plan.n, tau_scr=plan.tau_scr, tau_cb=plan.tau_cb, p=14,
              values=plan.values, ti=1024, n_bands=plan.n_bands,
              use_cb=True, use_smh=True)
    err, hits = kernel_vs_plain(torch, screen, args, kw)
    print(f"  p=14 ti=1024 tiles={chunk} bins={len(plan.values) - 1}: "
          f"hits={hits} max_abs_err={err}")
    check(err == 0, "p=14 kernel != plain")
    check(hits > 0, "p=14 comparison saw no hits")
    max_err = max(max_err, err)
    k_ms = cuda_ms(torch, lambda: screen.screen_hits_fused(*args, **kw), 5)
    p_ms = cuda_ms(torch, lambda: screen._screen_hits_fused_plain(
        *args, **kw), 2)
    pairs64 = chunk * 1024 * 1024
    print(f"  [{card}] K1 {k_ms:.3f} ms / plain {p_ms:.3f} ms per launch of "
          f"{chunk} tiles ({pairs64 / k_ms * 1e3:.4g} vs "
          f"{pairs64 / p_ms * 1e3:.4g} tile pairs/s)")

    k2_err = phase_k2_small(torch, screen, dev)
    t0 = time.perf_counter()
    hbank, hpicks = hll_bench_bank(models, synth, 16384,
                                   np.random.default_rng(0x4A11), 300)
    print(f"  hll bench bank N=16384 p=14 p_aux=8 with {len(hpicks)} planted "
          f"pairs made in {time.perf_counter() - t0:.1f} s (host)")
    hparams = SelectionParams(tau=0.9, criterion="hll_a")
    hplan = screened.ScreenPlan(hbank, hparams, 1024, device=dev)
    hr, hc = scheduler.triangle_block_ids(hplan.e_s, hplan.tau, 1024,
                                          use_cb_skip=False)
    hr64 = torch.from_numpy(hr[:chunk].astype(np.int32)).to(dev)
    hc64 = torch.from_numpy(hc[:chunk].astype(np.int32)).to(dev)
    k2_args = [hplan.d_aux_regs, hr64, hc64]
    k2_kw = dict(p=8, values=hplan.values_aux, ti=1024, tj=1024)
    err = k2_vs_plain(torch, screen, k2_args, k2_kw)
    print(f"  K2 p_aux=8 ti=1024 tiles={chunk} "
          f"bins={len(hplan.values_aux) - 1}: max_abs_err={err}")
    check(err == 0, "K2 p_aux=8 ti=1024 kernel != plain")
    k2_err = max(k2_err, err)
    k2_ms = cuda_ms(torch, lambda: screen.screen_s_z(*k2_args, **k2_kw), 5)
    k2_plain_ms = cuda_ms(torch, lambda: screen._screen_s_z_plain(
        *k2_args, **k2_kw), 2)
    hll_chunk_ms = cuda_ms(torch, lambda: hplan.screen_chunk(
        hr[:chunk], hc[:chunk]), 3)
    print(f"  [{card}] K2 {k2_ms:.3f} ms / plain {k2_plain_ms:.3f} ms per "
          f"launch of {chunk} tiles at p_aux=8; hll screen chunk (K1 + K2 + "
          f"aux compare) {hll_chunk_ms:.3f} ms")

    print("== phase 4: selection CLI, N=2048", flush=True)
    rng4 = np.random.default_rng(2048)
    n4 = 2048
    items = np.exp(rng4.uniform(np.log(256), np.log(32768), n4)).astype(
        np.int64)
    # the primary registers of synthetic_regs(n4, items, 14, rng4), with
    # aux HLLs at p_aux=8 from the same hashes
    regs4, hll4 = synth.synthetic_hll_banks(n4, items, (14, 8), rng4)
    aux4 = synth.synthetic_aux(n4, 32, rng4)
    for i in synth.plant_near_duplicates(regs4, aux4, rng4, 64):
        hll4[i + 1] = hll4[i]
    with tempfile.TemporaryDirectory() as tmp:
        names = [os.path.join(tmp, f"g{i:04d}.fna.gz") for i in range(n4)]
        for name, r, a, h in zip(names, regs4, aux4, hll4):
            formats.write_hll(name + ".hll", 14, r)
            formats.write_smh(name + ".smh32", a)
            formats.write_hll(name + ".hll_8", 8, h)
        lst = os.path.join(tmp, "list.txt")
        with open(lst, "w") as fh:
            fh.write("\n".join(names) + "\n")
        for crit in ("smh_a", "cb", "baseline", "hll_a", "hll_an"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["-l", lst, "-a", "256", "-h", "0.9", "-c",
                               crit])
            t_cli = time.perf_counter() - t0
            check(rc == 0, f"cli exit {rc}")
            got = buf.getvalue().splitlines()
            t0 = time.perf_counter()
            fbank = models.SketchBank.from_sketch_files(
                names, criterion=None if crit in ("cb", "baseline") else crit)
            if crit == "baseline":
                # select_pairs_host would run 2.1M scalar MLE loops here;
                # the vectorized oracle is the same f64 cascade
                # (tests/test_torch_hostref.py holds them equal)
                order = fbank.sorted_by_cardinality()
                oracle = hostref.PairOracle(
                    14, fbank.regs[order], np.trunc(fbank.cards[order]),
                    criterion="baseline", tau=0.9, apply_cb=False)
                ii, kk = np.triu_indices(n4, 1)
                want = format_results(
                    [(names[order[i]], names[order[k]], j)
                     for i, k, j in oracle.confirm_pairs(zip(ii, kk))])
                how = "PairOracle.confirm_pairs over all pairs"
            else:
                want = format_results(hostref.select_pairs_host(
                    fbank, 0.9, crit))
                how = "select_pairs_host"
            print(f"  [{card}] -c {crit}: {len(got)} lines in {t_cli:.2f} s;"
                  f" host reference ({how}) {len(want)} lines in "
                  f"{time.perf_counter() - t0:.1f} s")
            check(got == want, f"cli -c {crit} differs from host reference")
            check(len(got) >= 32, f"cli -c {crit} found too few pairs")

    print("== phase 5: main path, select_pairs smh_a N=16384 p=14",
          flush=True)
    out, launches = run_main_path(torch, screen, select_pairs, bank, params,
                                  dev, card)
    check(launches["screen_fused"] > 0, "main path never launched K1")
    verify_pairs(hostref, bank, picks, out, "smh_a")

    # screen throughput over the full i<j triangle (all 136 tiles)
    spans = [(c0, min(chunk, len(tri_r) - c0))
             for c0 in range(0, len(tri_r), chunk)]
    dev_tiles = [(torch.from_numpy(tri_r[c0:c0 + w].astype(np.int32)).to(dev),
                  torch.from_numpy(tri_c[c0:c0 + w].astype(np.int32)).to(dev))
                 for c0, w in spans]

    def sweep():
        for rr, cc in dev_tiles:
            screen.screen_hits_fused(plan.d_regs, rr, cc, plan.d_e,
                                     plan.d_fp, **kw)

    tri_ms = cuda_ms(torch, sweep, 3)
    tri_pairs = scheduler.pair_count(
        scheduler.triangle_blocks(plan.e_s, plan.tau, 1024, False), plan.n)
    print(f"  [{card}] full-triangle screen: {len(tri_r)} tiles, "
          f"{tri_pairs} pairs in {tri_ms:.3f} ms = "
          f"{tri_pairs / tri_ms * 1e3:.6g} pairs/s")

    print("== phase 6: hll main path, select_pairs hll_a / hll_an N=16384 "
          "p=14 p_aux=8", flush=True)
    for crit in ("hll_a", "hll_an"):
        out, hl = run_main_path(torch, screen, select_pairs, hbank,
                                SelectionParams(tau=0.9, criterion=crit),
                                dev, card)
        check(hl["screen_fused"] > 0 and hl["weighted_cdf_sum"] > 0,
              f"-c {crit} never launched K1 and K2")
        verify_pairs(hostref, hbank, hpicks, out, crit)
        for name in launches:
            launches[name] += hl[name]

    hspans = [(c0, min(chunk, len(hr) - c0))
              for c0 in range(0, len(hr), chunk)]

    def hll_sweep():
        for c0, w in hspans:
            hplan.screen_chunk(hr[c0:c0 + w], hc[c0:c0 + w])

    hll_ms = cuda_ms(torch, hll_sweep, 3)
    htri_pairs = scheduler.pair_count(
        scheduler.triangle_blocks(hplan.e_s, hplan.tau, 1024, False),
        hplan.n)
    print(f"  [{card}] full-triangle hll screen (K1 + K2 + aux compare): "
          f"{len(hr)} tiles, {htri_pairs} pairs in {hll_ms:.3f} ms = "
          f"{htri_pairs / hll_ms * 1e3:.6g} pairs/s")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    measured = {"screen_fused": (max_err, k_ms, p_ms),
                "weighted_cdf_sum": (k2_err, k2_ms, k2_plain_ms)}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name], "max_abs_err": measured[name][0],
        "ms": measured[name][1], "plain_ms": measured[name][2]}
        for name, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
