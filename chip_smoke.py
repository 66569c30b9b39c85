#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA card: builds the CUDA
kernels from this checkout, holds each against its plain PyTorch version,
runs the selection CLI end to end and drives the main paths at the
reference bench's bank size.

    python3 chip_smoke.py            # needs one CUDA card; under 10 minutes

Phases (any failure exits non-zero, without the final result line):
  1. device   - card name and power limit, torch / CUDA / nvcc versions
  2. build    - nvcc builds every csrc/*.cu for sm_90a, all at once; the
                ptxas log must show no spill and no serialized wgmma;
                g++ builds the host library native/fastx.cpp (libfastx)
                meanwhile: seconds, compiler and zlib versions; the run
                fails if it does not build
  3. kernel   - K1 vs its plain version, bit-equal hits and counts,
                each single-bank case through both entry points
                (screen_hits_fused, and the strip entry with one bank on
                both sides and bases 0): p=8
                (ti=64, every gate combination, with and without zero
                registers, n_real < n, a truncated value list); planes
                padded to one pipeline stage (p=5) and 8 bins (p=9); a
                launch whose every block takes the gate skip; one live
                pair at a block corner; n_real inside a block; and the
                first 64 tiles of the bench triangle at p=14, ti=1024 in
                two configurations, dense (the hll_a primary call: CB, no
                bands) and gated (smh_a: CB and LSH bands), each timed
                beside its plain version, its bound and torch._int_mm
                counting the same CDFs. K1's strip variant (the ring's
                screen) vs its plain version: strips of 192 and 256 rows
                at p=8, the column strip after, level with and before the
                row strip and the triangle's edge inside a block, n_real
                inside the column strip, every gate combination, with and
                without zeros; and 64 tile pairs at p=14, ti=1024 between
                two 4096-row strips of the hll bench bank, timed beside
                its plain version, its bound and torch._int_mm with a
                column bank. K2 vs its plain version, bit-equal
                S and Z: p_aux = 5, 6, 8 (ti=64, tj=64 and 128, a separate
                column bank, with and without zeros, a truncated value
                list); p = 5, 7, 8, 9, 10, 14 with 1, 2, 3, 5 and 13 bins
                at ti=192, tj=64 (one, two, four and many mma depths a bin,
                a part-filled last stage, blocks past the tile edge), with
                a column bank of another row count and without zeros; and
                p_aux=8, ti=1024 on the first 64 tiles of the hll bench
                bank; K2, plain, bound and torch._int_mm there. The
                gate-count kernel (the gate prune) vs its plain version,
                bit-equal counts: the CPU tests' cases
                (tests/gate_cases.py: 1, 2, 3, 4, 8, 16, 32 and 64 bands,
                every gate combination, n_real inside a tile, empty
                columns, CB ties, strips before, level with and after each
                other, ragged tiles of 130, 300 and 1024 rows, tiles past
                the strips' ends), then every tile of a 524,288-row
                triangle shaped as smh_a-524k's (131,328 tiles, 8 bands),
                the kernel timed over it beside its plain version in
                256-tile chunks and its bound
  4. cli      - planted .hll/.smh32/.hll_8 files for N=2048 genomes, read
                by the native threaded loaders and the numpy readers
                (bit-equal, both walls); the native fused union
                histograms against the numpy ones on 2^16 pairs; the
                run fails unless libfastx is available; the native row
                histograms (fastx.row_hist, the cards' pass) against
                the numpy ones on the p=14 bank, bit-equal, both walls; the
                selection CLI's lines for smh_a, cb, baseline, hll_a and
                hll_an must equal the exact host reference's (its wall,
                on the native histograms)
  5. main     - host_cards on the N=16384 bank (its wall) bit-equal to
                the MLE of the numpy row histograms (their wall);
                select_pairs(smh_a, tau=0.9) on N=16384 genomes at p=14
                (256 MiB of registers on the card) with planted
                near-duplicates: every planted pair the exact oracle passes
                is emitted, every emitted pair is oracle-confirmed with the
                identical Jaccard, and K1 and the gate-count kernel
                were launched; stage walls, a
                profiler trace of one warm run and the screen's pairs/s
                over the full triangle
  6. hll      - select_pairs(hll_a) and (hll_an), tau=0.9, on N=16384
                genomes at p=14 with aux HLLs at p_aux=8 from the same
                hashes, planted near-duplicates: the checks of phase 5, K1
                and K2 launched; stage walls, peak device memory, a
                profiler trace of one warm hll_a run and the hll screen's
                (K1 + K2 + aux compare) pairs/s over the full triangle
  7. fasta    - a synthetic bacterial corpus (96 gzipped FASTA genomes of
                0.5-6 Mbp with plasmids, 16 copies at SNP rate 0.001, 8 at
                0.02, 4 tiny FASTQ): build_bank_from_files on the card
                bit-equal to the CPU build on a subset (smh_a -a 256,
                hll_a -a 256, smh_a -a 4096; written files byte-identical);
                the build_sketch CLI on the whole corpus (-c smh_a and
                hll_a) with -t 8 on the device pipeline fed by the native
                decoder (wall and stage split) and on the native host
                builder (wall), and on a subset with the pure-Python
                decoder and with the native one, all files byte-identical;
                the decode rate of both readers on one thread; a profiler
                trace of one warm pack; the selection CLI on the files it
                wrote for
                smh_a, smh_only, cb, hll_a and hll_an against the host
                reference (every 0.001 copy the exact oracle passes
                emitted, no 0.02 copy emitted, K1 and K2 launched);
                time_smh -m 32 rows well-formed, K1 launched in its
                smh_a_kernel row
  8. dense    - the dense exact engine (indicator products and the
                ERTL-MLE as torch ops; no hand-written kernel): the
                selection CLI with --engine dense on phase 4's files for
                smh_a (--precision bf16 and int8), smh_only, cb, baseline,
                hll_a and hll_an equal to the host reference and the
                screened engine's lines; select_pairs(engine="dense") on
                the phase 5 and 6 banks (smh_a, hll_a) with the checks of
                phase 5, its wall and per-tile split (products, MLE)
                beside the screened engine's wall; the card's f64 MLE in
                ulp from hostref.ertl_mle_batch and the f32 MLE's relative
                error; a checkpointed screened sweep cut to two records
                and a torn line resumes to the same pairs with fewer K1
                launches
  9. multi    - the multi-device engines on a mesh that names the card four
                times (four virtual devices: strips with non-zero bases):
                select_pairs_ring and select_pairs_screened_sharded for
                smh_a and hll_a on the phase 5 and 6 banks (K1's strip
                variant and K2 launched), the ring for smh_a on N=65536
                genomes (1 GiB of registers, strips of 256 MiB) read one
                chunk a wave, with a position's masks within chunk_tiles *
                ti^2 bytes and the card's allocator at each read within
                the four positions' masks, each with
                the checks of phase 5 and lines equal to the screened
                engine's, walls and stage splits; the selection CLI with
                --engine ring, --engine sharded, --sharded and --engine
                dense-sharded on phase 4's files equal to the host
                reference; select_pairs_multihost over 3 explicit tile
                slices, merged, equal to the screened engine
 10. l5       - the reference's experiment protocols
                (cuda_selection_criteria_tpu_torch/experiments): the
                differential at tau=0.01 (compare_engines: smh_a, hll_a
                and baseline on a prefix of phase 4's files against the
                scalar host engine, 0 mismatches, every delta 0, every
                pair phase 4 emitted at 0.9 there; then selection -c
                baseline -h 0.01 on all of phase 4's files equal to the
                pooled oracle, with its candidates, screen and confirm
                walls and confirm pairs/s); the timing sweep
                (run_time_experiment, both arms, m 64 and 512, blocks 256
                and 512) on phase 7's corpus, every row present; the
                confirm stage's rates (confirm_throughput) on the phase 5
                bank with 2^19 pairs: host and device-assisted at
                tau=-100, the reject bound off and on at 0.9, outputs equal
 11. scale    - the at-scale validation harnesses
                (cuda_selection_criteria_tpu_torch/experiments):
                validate_screened (smh_a, tau 0.8, N=512) and
                validate_hllaux (hll_a and hll_an, N=256: K2) exactly equal
                to the scalar host reference; the planted bench bank at
                N=131072 (2 GiB of registers, 128 planted pairs, tau 0.9,
                ti 1024) through validate_131k_scale.run: stage walls, the
                gate prune's split, the slab-pipelined upload's split
                (upload_stats), the plan stage's peak device memory within
                the padded bank + 0.5 GiB, the whole run's peak beside the
                card's, host RAM, the planted pairs recovered and phase 5's
                checks; validate_ring_scale.run on the same bank on one
                strip and on two strips of the card (K1's strip entry),
                pairs equal
 12. bench    - the bench protocol (experiments/bench.py, kernel_tuning.py,
                scale_sweep.py): the card's measured copy bandwidth and the
                baseline it gives (2 x 16 KiB read a pair); bench.record at
                N=16384, ti=1024 (headline: K1's chunk function with its
                gates, the count fetch and the hit extraction, reps back to
                back; raw: K2 at p=14; tc_util; vs_baseline), the headline
                sweep's per-tile counts equal to K1's plain version's; K2
                at p=14, ti = tj = 1024 on 64 tiles of the bench triangle
                bit-equal to its plain version, timed beside it, its bound
                and torch._int_mm; three kernel_tuning configurations;
                scale_sweep at N=4096

The last two lines are a JSON record of the kernels (launches on the main
paths of phases 5 to 7, times, bounds, library times, K2's p=14 record,
and the launches of phase 9's ring and tile-sharded runs, of phase 10, of
phase 11 and of phase 12's bench in records of their own) and the result
line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import contextlib
import filecmp
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "cuda_selection_criteria_tpu_torch"
KERNELS = {  # name -> (source, the TPU kernel it replaces, route detail)
    "screen_fused": (f"{PKG}/csrc/screen_fused.cu",
                     "cuda_selection_criteria_tpu/ops/screen.py:338",
                     "b1 wgmma.mma_async m64n128k256 .and.popc"),
    "weighted_cdf_sum": (f"{PKG}/csrc/weighted_cdf_sum.cu",
                         "cuda_selection_criteria_tpu/ops/screen.py:99",
                         "b1 wgmma.mma_async m64n128k256 .and.popc, the "
                         "bins' mma depths four a pipeline stage"),
    # an XLA fusion, not a Pallas kernel; its strip twin is
    # cuda_selection_criteria_tpu/parallel/ring.py:232 _ring_gate_counts
    "gate_counts": (f"{PKG}/csrc/gate_counts.cu",
                    "cuda_selection_criteria_tpu/parallel/screened.py:232",
                    "XLA fusions _gate_counts and _ring_gate_counts "
                    "(parallel/ring.py:232): int32 compares on the CUDA "
                    "cores, one CTA a 128-row block, columns staged in "
                    "shared memory, one atomicAdd a CTA"),
}


def rates():
    """(B1_COMPARISONS_PER_S, HBM_BYTES_PER_S) of the port's utils/hopper:
    the bounds' rates, the bench's too (read once the package is on the
    path)."""
    from cuda_selection_criteria_tpu_torch.utils import hopper
    return hopper.B1_COMPARISONS_PER_S, hopper.HBM_BYTES_PER_S


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


def max_err(torch, got, want):
    """max |difference| over the hits and counts of two K1 results."""
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype, "shape/dtype")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()))
    return err


def kernel_vs_plain(torch, screen, args, kw):
    """Launch K1 through both entry points (screen_hits_fused, and the strip
    entry with one bank on both sides and bases 0) and its plain version on
    the same card tensors; return the max |difference| over hits and
    counts (must be 0) and the hits."""
    got = screen.screen_hits_fused(*args, **kw)
    regs, rows, cols, e, fp = args
    strip = screen.screen_hits_fused_strips(regs, regs, rows, cols, e, e, fp,
                                            fp, 0, 0, **kw)
    want = screen._screen_hits_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    return (max(max_err(torch, got, want), max_err(torch, strip, want)),
            int(got[1].sum()))


# K1's strip cases: a 192-row row strip and a 256-row column strip, with
# (row_base, col_base) putting the column strip after, level with and
# before the row strip, and the triangle's edge inside a 128-edge block
STRIP_BASES = {"below": (0, 192), "equal": (64, 64), "above": (256, 192),
               "edge in block": (96, 64)}


def strip_inputs(screened, seed, lo, n_r, n_c):
    """((regs, e, fp) of the row strip, of the column strip) at p=8: rows
    of the column strip copy rows (and fingerprints) of the row strip."""
    rows = edge_inputs(screened, seed, lo, 11, n_r, 8)
    cols = edge_inputs(screened, seed + 1, lo, 11, n_c, 8)
    for r, c in ((7, 5), (70, 130), (150, 250), (100, 64)):
        for a, b in zip(cols, rows):
            a[c] = b[r]
    return rows, cols


def strips_vs_plain(torch, screen, args, kw):
    """K1's strip entry and its plain version on the same card tensors:
    (max |difference|, hits)."""
    got = screen.screen_hits_fused_strips(*args, **kw)
    want = screen._screen_hits_fused_strips_plain(*args, **kw)
    torch.cuda.synchronize()
    return max_err(torch, got, want), int(got[1].sum())


def phase_kernel_strips(torch, screen, screened, dev):
    """K1's strip variant against its plain version, bit-equal, at p=8:
    distinct strips of 192 and 256 rows, every base placement, n_real
    inside the column strip, every gate combination, with and without zero
    registers (ti=64); and ti=128 with large cardinalities, where the
    triangle's edge alone bounds the hits inside a block."""
    worst = 0
    cases = []
    for label, bases in STRIP_BASES.items():
        for use_cb in (True, False):
            for use_smh in (True, False):
                for lo in (0, 2):
                    cases.append((label, bases, use_cb, use_smh, lo, 64))
        cases.append((label, bases, True, False, 0, 128))
    for label, (row_base, col_base), use_cb, use_smh, lo, ti in cases:
        n_r, n_c = (192, 256) if ti == 64 else (256, 384)
        rows, cols = strip_inputs(screened, 200 + use_cb + 2 * use_smh, lo,
                                  n_r, n_c)
        if ti == 128:
            rows[1][:] = cols[1][:] = 1.0e6
        r_t, c_t = (([0, 1, 2, 0, 2], [0, 3, 1, 2, 3]) if ti == 64
                    else ([0, 0], [0, 1]))
        t = [torch.from_numpy(x).to(dev) for x in (*rows, *cols)]
        args = (t[0], t[3], torch.tensor(r_t, dtype=torch.int32, device=dev),
                torch.tensor(c_t, dtype=torch.int32, device=dev), t[1], t[4],
                t[2], t[5], row_base, col_base)
        vals = screen.bank_values(np.concatenate([rows[0], cols[0]]))
        kw = dict(n_real=col_base + (150 if ti == 64 else 200),
                  tau_scr=0.4 if ti == 64 else 0.9, tau_cb=0.35, p=8,
                  values=vals, ti=ti, n_bands=4, use_cb=use_cb,
                  use_smh=use_smh)
        err, hits = strips_vs_plain(torch, screen, args, kw)
        print(f"  K1 strips {label} (bases {row_base}, {col_base}) ti={ti} "
              f"cb={use_cb} smh={use_smh} zeros={lo == 0}: hits={hits} "
              f"max_abs_err={err}")
        check(err == 0, f"K1 strips {label}: kernel != plain")
        check(ti == 64 or hits > 0, f"K1 strips {label} ti=128: no hits")
        worst = max(worst, err)
    return worst


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


def edge_inputs(screened, seed, lo, hi, n, p):
    """uint8 registers in [lo, hi), sorted f32 cardinalities with 3 empty
    rows, LSH fingerprints with every fifth row a near-duplicate of row 0."""
    rng = np.random.default_rng(seed)
    regs = rng.integers(lo, hi, size=(n, 1 << p), dtype=np.uint8)
    e = np.sort(rng.uniform(0, 5000, n)).astype(np.float32)
    e[:3] = 0.0
    aux = rng.integers(0, 1 << 63, size=(n, 16), dtype=np.uint64)
    aux[1::5] = aux[0]
    return regs, e, screened.band_fingerprints_np(aux, 4, 4)


def phase_kernel_edges(torch, screen, screened, dev):
    """K1 against its plain version where the redesign has edges: planes
    padded to one pipeline stage (p = 5) and more bins than one group, a
    launch whose every block takes the gate skip, exactly one live pair at
    a block corner (i, j) = (63, 64), and n_real inside a block."""
    worst = 0
    cases = []
    for p, hi, scale in ((5, 6, 1.0), (9, 9, 4.0)):  # some pairs fail h
        regs, e, fp = edge_inputs(screened, 50 + p, 0, hi, 256, p)
        e *= np.float32(scale)
        cases.append((f"p={p} bins={hi - 1}", regs, e, fp, [0, 0, 1, 2],
                      [0, 2, 1, 2], 64, dict(use_cb=False, use_smh=False),
                      None, None))
    regs, e, fp = edge_inputs(screened, 71, 0, 12, 512, 8)
    cases.append(("every block skipped", regs, e, fp, [1, 3, 2], [0, 1, 0],
                  128, dict(use_cb=True, use_smh=False), None, 0))
    regs, e, fp = edge_inputs(screened, 83, 0, 12, 256, 8)
    e[:] = 1.0e6
    fp = np.arange(256 * 4, dtype=np.int32).reshape(256, 4)
    fp[64, 2] = fp[63, 2]
    regs[64] = regs[63]
    for ti, rows, cols in ((64, [0], [1]), (128, [0], [0])):
        cases.append((f"one live pair (63, 64) ti={ti}", regs, e, fp, rows,
                      cols, ti, dict(use_cb=False, use_smh=True), None, 1))
    regs, e, fp = edge_inputs(screened, 190, 0, 12, 256, 8)
    e[:] = 1.0e6
    cases.append(("n_real=100 inside a block", regs, e, fp, [0, 0, 1],
                  [0, 1, 1], 128, dict(use_cb=True, use_smh=False), 100,
                  None))
    for label, regs, e, fp, rows, cols, ti, gates, n_real, want in cases:
        args = [torch.from_numpy(regs).to(dev),
                torch.tensor(rows, dtype=torch.int32, device=dev),
                torch.tensor(cols, dtype=torch.int32, device=dev),
                torch.from_numpy(e).to(dev), torch.from_numpy(fp).to(dev)]
        vals = screen.bank_values(regs)
        kw = dict(n_real=regs.shape[0] - 5 if n_real is None else n_real,
                  tau_scr=0.9, tau_cb=0.5, p=int(np.log2(regs.shape[1])),
                  values=vals, ti=ti, n_bands=fp.shape[1], **gates)
        err, hits = kernel_vs_plain(torch, screen, args, kw)
        print(f"  K1 {label}: bins={len(vals) - 1} hits={hits} "
              f"max_abs_err={err}")
        check(err == 0, f"K1 {label}: kernel != plain")
        check(want is None or hits == want, f"K1 {label}: {hits} hits")
        check(want is not None or hits > 0, f"K1 {label}: no hits")
        worst = max(worst, err)
    return worst


def bound(ops_secs, bytes_secs):
    """(bound_ms, bound_by): the larger of the two times."""
    return (max(ops_secs, bytes_secs) * 1e3,
            "operations" if ops_secs >= bytes_secs else "bytes")


def int_mm_ms(torch, regs, rows, cols, values, ti, tj, regs_cols=None):
    """Yardstick of the CDF counts (used nowhere in the port): nbins x T
    torch._int_mm calls on int8 indicator banks built beforehand, CUDA
    events. The first tile's bin-0 counts are checked against the plain
    version's indicator product first."""
    regs_cols = regs if regs_cols is None else regs_cols
    thr = values[:-1]
    ind = [((regs <= v).to(torch.int8), (regs_cols <= v).to(torch.int8))
           for v in thr]
    spans = [(r * ti, c * tj) for r, c in zip(rows.tolist(), cols.tolist())]
    r0, c0 = spans[0]
    got = torch._int_mm(ind[0][0][r0:r0 + ti], ind[0][1][c0:c0 + tj].t())
    want = ((regs[r0:r0 + ti] <= thr[0]).to(torch.float32)
            @ (regs_cols[c0:c0 + tj] <= thr[0]).to(torch.float32).T)
    check(torch.equal(got.to(torch.float32), want),
          "torch._int_mm counts != the plain indicator product")

    def run():
        for a, b in ind:
            for r0, c0 in spans:
                torch._int_mm(a[r0:r0 + ti], b[c0:c0 + tj].t())

    ms = cuda_ms(torch, run, 2)
    del ind
    return ms


def k1_config(torch, screen, label, args, kw, card):
    """K1 on one 64-tile launch against its plain version (bit-equal),
    timed beside the plain version, its bound and the library yardstick.
    The bound counts 2^p comparisons a bin for each pair that passes the
    gates (the plain _fused_gates on the same inputs) at
    B1_COMPARISONS_PER_S, against the bytes: the int8 hits written once and
    2^p a distinct bank row the launch reads, at HBM_BYTES_PER_S (rates())."""
    b1, hbm = rates()
    err, hits = kernel_vs_plain(torch, screen, args, kw)
    nbins = len(kw["values"]) - 1
    print(f"  K1 {label} p={kw['p']} ti={kw['ti']} tiles={len(args[1])} "
          f"bins={nbins}: hits={hits} max_abs_err={err}")
    check(err == 0, f"K1 {label}: kernel != plain")
    check(hits > 0, f"K1 {label}: the comparison saw no hits")
    plain_ms = cuda_ms(torch, lambda: screen._screen_hits_fused_plain(
        *args, **kw), 2)
    ms = cuda_ms(torch, lambda: screen.screen_hits_fused(*args, **kw), 5)
    regs, rows, cols, e, fp = args
    ti, r = kw["ti"], regs.shape[1]
    g = screen._fused_gates(rows, cols, e, fp, kw["n_real"], kw["tau_scr"],
                            kw["tau_cb"], ti, kw["n_bands"], kw["use_cb"],
                            kw["use_smh"])[2]
    gated = int(g.sum())
    del g
    n_ids = int(torch.unique(torch.cat([rows, cols])).numel())
    bound_ms, bound_by = bound(gated * nbins * r / b1,
                               (len(rows) * ti * ti + n_ids * ti * r) / hbm)
    library_ms = int_mm_ms(torch, regs, rows, cols, kw["values"], ti, ti)
    ms2 = cuda_ms(torch, lambda: screen.screen_hits_fused(*args, **kw), 5)
    print(f"  [{card}] K1 {label}: {ms:.3f} / {ms2:.3f} ms (two turns) vs "
          f"plain {plain_ms:.3f} ms per launch; {gated} of "
          f"{len(rows) * ti * ti} pairs pass the gates; bound {bound_ms:.3f}"
          f" ms ({bound_by}), share of the bound {bound_ms / ms:.3f}; "
          f"library (torch._int_mm, {nbins} x {len(rows)} calls) "
          f"{library_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def k1_strips_config(torch, screen, plan, card):
    """K1's strip variant on the ring's shape: 64 tile pairs at p=14,
    ti=1024 between two 4096-row strips of the hll bench bank (rows
    4096-8191 against rows 8192-12287, its 16 tile pairs four times; the
    hll_a primary call: CB, no bands), against its plain version
    (bit-equal), timed beside it, its bound and torch._int_mm with a
    column bank; the bound as in k1_config."""
    b1, hbm = rates()
    ti, r = 1024, 1 << 14
    rows = slice(4096, 8192)
    cols = slice(8192, 12288)
    rr, cc = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    r_t = torch.from_numpy(np.tile(rr.ravel(), 4).astype(np.int32)).to(
        plan.d_regs.device)
    c_t = torch.from_numpy(np.tile(cc.ravel(), 4).astype(np.int32)).to(
        plan.d_regs.device)
    args = (plan.d_regs[rows], plan.d_regs[cols], r_t, c_t, plan.d_e[rows],
            plan.d_e[cols], plan.d_fp[rows], plan.d_fp[cols], 4096, 8192)
    kw = dict(n_real=plan.n, tau_scr=plan.tau_scr, tau_cb=plan.tau_cb, p=14,
              values=plan.values, ti=ti, n_bands=1, use_cb=True,
              use_smh=False)
    err, hits = strips_vs_plain(torch, screen, args, kw)
    nbins = len(kw["values"]) - 1
    print(f"  K1 strips dense (hll_a primary) p=14 ti={ti} tiles={len(r_t)} "
          f"bins={nbins}: hits={hits} max_abs_err={err}")
    check(err == 0, "K1 strips dense: kernel != plain")
    check(hits > 0, "K1 strips dense: the comparison saw no hits")
    plain_ms = cuda_ms(torch, lambda: screen._screen_hits_fused_strips_plain(
        *args, **kw), 2)
    ms = cuda_ms(torch, lambda: screen.screen_hits_fused_strips(*args, **kw),
                 5)
    g = screen._strip_gates(r_t, c_t, args[4], args[5], args[6], args[7],
                            4096, 8192, kw["n_real"], kw["tau_scr"],
                            kw["tau_cb"], ti, 1, True, False)[2]
    gated = int(g.sum())
    del g
    bound_ms, bound_by = bound(gated * nbins * r / b1,
                               (len(r_t) * ti * ti + 8 * ti * r) / hbm)
    library_ms = int_mm_ms(torch, args[0], r_t, c_t, kw["values"], ti, ti,
                           regs_cols=args[1])
    ms2 = cuda_ms(torch, lambda: screen.screen_hits_fused_strips(*args, **kw),
                  5)
    print(f"  [{card}] K1 strips dense: {ms:.3f} / {ms2:.3f} ms (two turns) "
          f"vs plain {plain_ms:.3f} ms per launch; {gated} of "
          f"{len(r_t) * ti * ti} pairs pass the gates; bound {bound_ms:.3f} "
          f"ms ({bound_by}), share of the bound {bound_ms / ms:.3f}; library "
          f"(torch._int_mm, {nbins} x {len(r_t)} calls) {library_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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


def k2_bound(torch, rows, cols, values, p, ti):
    """(bound_ms, bound_by) of one K2 launch over tiles (rows, cols) at
    ti = tj: the comparisons (2^p a bin of each pair) at
    B1_COMPARISONS_PER_S against the bytes, f32 S (and Z when 0 is
    present) written once and 2^p a distinct bank row read, at
    HBM_BYTES_PER_S."""
    b1, hbm = rates()
    pairs = len(rows) * ti * ti
    n_ids = int(torch.unique(torch.cat([rows, cols])).numel())
    out_bytes = 8 if values[0] == 0 else 4
    return bound(pairs * (len(values) - 1) * (1 << p) / b1,
                 (pairs * out_bytes + n_ids * ti * (1 << p)) / hbm)


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


def phase_k2_edges(torch, screen, dev):
    """K2 against its plain version where its walk over the mma depths has
    edges: a plane padded to one depth (p < 8), one, two and four depths a
    bin (p = 8, 9, 10), a bin of many stages (p = 14); bin counts that
    leave the last stage part-filled; ti = 192 and tj = 64 (odd multiples
    of 64: blocks reach past the tile edge); a column bank with another row
    count; 0 absent (no Z); a tile listed twice."""
    worst = 0.0
    rows = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=dev)
    ctl = torch.tensor([0, 4, 4, 3], dtype=torch.int32, device=dev)
    for p in (5, 7, 8, 9, 10, 14):
        for nbins in (1, 2, 3, 5, 13):
            for lo, sep_cols in ((0, nbins % 2 == 1), (2, nbins % 2 == 0)):
                rng = np.random.default_rng(1000 * p + 10 * nbins + lo)
                regs = rng.integers(lo, lo + nbins + 1, size=(384, 1 << p),
                                    dtype=np.uint8)
                cols = (rng.integers(lo, lo + nbins + 1, size=(320, 1 << p),
                                     dtype=np.uint8) if sep_cols else None)
                vals = screen.bank_values(
                    regs if cols is None else np.concatenate([regs, cols]))
                check(len(vals) == nbins + 1, f"K2 p={p}: {vals} present")
                kw = dict(p=p, values=vals, ti=192, tj=64, regs_cols=(
                    None if cols is None else torch.from_numpy(cols).to(dev)))
                err = k2_vs_plain(torch, screen, [
                    torch.from_numpy(regs).to(dev), rows, ctl], kw)
                print(f"  K2 p={p} ti=192 tj=64 bins={nbins} "
                      f"regs_cols={sep_cols} zeros={lo == 0} "
                      f"row_words={screen.plane_row_words(p, nbins)}: "
                      f"max_abs_err={err}")
                check(err == 0, f"K2 p={p} bins={nbins} kernel != plain")
                worst = max(worst, err)
    return worst


# The gate prune's shapes in smh_a-524k (BENCHMARK.json): 524,288 rows,
# m = 32 SMH buckets at tau 0.9 (8 bands), ti = 1024, the whole triangle
# (131,328 tiles; CB skips none there) in launches of GATE_LAUNCH_TILES;
# the plain version in the 256-tile chunks the prune gave it before.
GATE_N = 524288
GATE_PLAIN_CHUNK = 256


def gate_case_args(torch, case, dev):
    """gate_counts' positional arguments (without use_cb, use_smh) of a
    tests/gate_cases.py case, its arrays on dev."""
    t = [torch.from_numpy(case[k]).to(dev) for k in (
        "e_rows", "e_cols", "fp_rows", "fp_cols", "row_tiles", "col_tiles")]
    return (*t, case["row_base"], case["col_base"], case["n_real"],
            case["tau_cb"], case["n_bands"], case["ti"])


def gate_vs_plain(torch, screen, args):
    """max |kernel - plain| over one gate_counts call's counts."""
    got = screen.gate_counts(*args)
    want = screen._gate_counts_plain(*args)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          "gate_counts shape/dtype")
    if not got.numel():
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def phase_gate(torch, screen, screened, scheduler, criteria, dev, card):
    """The gate-count kernel (csrc/gate_counts.cu) against its plain
    version, bit-equal: the CPU tests' edge cases (tests/gate_cases.py:
    1 to 64 bands, every gate combination, strips before, level with and
    after each other, ragged tiles, tiles past the strips' ends), then
    every tile of a 524,288-row triangle shaped as smh_a-524k's, timed
    beside the plain version and the bound. Returns the kernel record."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import gate_cases as gc
    cases = [(f"bank n_bands={nb}", gc.bank_case(40 + nb, nb))
             for nb in gc.BANDS + (2, 3, 64)]
    cases += [(f"strips {w}", gc.strip_case(60 + len(w), b))
              for w, b in gc.STRIP_BASES.items()]
    cases += [(f"ragged ti={ti} bases={b}", gc.ragged_case(ti + b[0], ti,
                                                          bases=b))
              for ti in (130, 300, 1024) for b in ((0, 0), (140, 100),
                                                   (0, 300))]
    err = 0
    for label, case in cases:
        args = gate_case_args(torch, case, dev)
        for use_cb, use_smh in gc.GATES:
            e = gate_vs_plain(torch, screen, (*args, use_cb, use_smh))
            check(e == 0, f"gate_counts {label} cb={use_cb} smh={use_smh}: "
                  f"kernel != plain (max_abs_err {e})")
            err = max(err, e)
    cut, padded = gc.cut_strips(gc.ragged_case(11, 300, bases=(40, 0)), 700,
                                830)
    for use_cb, use_smh in gc.GATES[:3]:
        got = screen.gate_counts(*gate_case_args(torch, cut, dev), use_cb,
                                 use_smh)
        want = screen._gate_counts_plain(*gate_case_args(
            torch, padded, dev), use_cb, use_smh)
        check(torch.equal(got, want), "gate_counts: tiles past the strips' "
              "ends count other pairs than the padded plain version")
    print(f"  gate_counts: {len(cases)} edge cases x 4 gate combinations "
          f"and the strips' edges: max_abs_err={err}")

    rng = np.random.default_rng(0x6A7E)
    n_real = GATE_N - 37
    e = np.zeros(GATE_N, np.float32)
    e[:n_real] = np.sort(np.trunc(rng.normal(2048.0, 30.0, n_real)))
    n_bands = criteria.smh_band_params(32, 0.9)[1]
    fp = rng.integers(-2**31, 2**31, size=(GATE_N, n_bands)).astype(np.int32)
    near = rng.choice(n_real - 1, 400, replace=False)
    band = rng.integers(0, n_bands, near.size)
    fp[near + 1, band] = fp[near, band]  # planted pairs sharing a band
    tau = 0.9
    tau_cb = np.float32(tau * (1.0 - 1e-5))  # the plan's CB margin
    rows, cols = scheduler.triangle_block_ids(e[:n_real].astype(np.float64),
                                              tau, 1024, use_cb_skip=False)
    n_tiles = len(rows)
    d_e = torch.from_numpy(e).to(dev)
    d_fp = torch.from_numpy(fp).to(dev)

    def tiles(step):
        return [(torch.from_numpy(rows[c0:c0 + step].astype(np.int32)).to(
            dev), torch.from_numpy(cols[c0:c0 + step].astype(np.int32)).to(
            dev)) for c0 in range(0, n_tiles, step)]

    launch_tiles = tiles(screened.GATE_LAUNCH_TILES)
    plain_tiles = tiles(GATE_PLAIN_CHUNK)
    kw = dict(row_base=0, col_base=0, n_real=n_real, tau_cb=tau_cb,
              n_bands=n_bands, ti=1024, use_cb=True, use_smh=True)

    def kernel_triangle():
        return [screen.gate_counts(d_e, d_e, d_fp, d_fp, r, c, **kw)
                for r, c in launch_tiles]

    got = torch.cat(kernel_triangle())
    torch.cuda.synchronize()
    tri_ms = cuda_ms(torch, kernel_triangle, 3)
    # the plain version once over the whole triangle, timed and compared
    screen._gate_counts_plain(d_e, d_e, d_fp, d_fp, *plain_tiles[0], **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = [screen._gate_counts_plain(d_e, d_e, d_fp, d_fp, r, c, **kw)
            for r, c in plain_tiles]
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    want = torch.cat(want)
    tri_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(tri_err == 0, f"gate_counts N={GATE_N}: kernel != plain on the "
          f"triangle (max_abs_err {tri_err})")
    err = max(err, tri_err)
    tri_ms2 = cuda_ms(torch, kernel_triangle, 3)
    r0, c0 = plain_tiles[0]
    chunk_ms = cuda_ms(torch, lambda: screen.gate_counts(
        d_e, d_e, d_fp, d_fp, r0, c0, **kw), 20)

    # the bound: each pair of the triangle (i < j < n_real) needs its CB
    # compare and each pair passing CB its n_bands band tests (nearly no
    # pair shares a band, so none stops early), at the int32 rate; bytes:
    # e, fp and the tile lists read once, the counts written once
    e_real = e[:n_real]
    prod = (tau_cb * e_real).astype(np.float32)  # ascending, as e is
    cb_pass = int(np.maximum(np.searchsorted(prod, e_real, side="right")
                             - np.arange(1, n_real + 1), 0).sum())
    pairs = n_real * (n_real - 1) // 2
    ops = pairs + cb_pass * n_bands
    nbytes = e.nbytes + fp.nbytes + 3 * 4 * n_tiles
    from cuda_selection_criteria_tpu_torch.utils import hopper
    bound_ms, bound_by = bound(ops / hopper.INT32_OPS_PER_S,
                               nbytes / rates()[1])
    live = int((got > 0).sum())
    print(f"  [{card}] gate_counts N={GATE_N} ti=1024 n_bands={n_bands}: "
          f"{n_tiles} tiles in {len(launch_tiles)} launches, {tri_ms:.3f} / "
          f"{tri_ms2:.3f} ms (two turns) for the triangle; plain "
          f"{plain_ms:.3f} ms in {len(plain_tiles)} chunks of "
          f"{GATE_PLAIN_CHUNK} ({plain_ms / len(plain_tiles):.3f} ms a "
          f"chunk; the kernel {chunk_ms:.3f} ms on one); bound "
          f"{bound_ms:.3f} ms ({bound_by}: {pairs} pairs, {cb_pass} passing "
          f"CB, {ops:.6g} compares, {nbytes} bytes), share of the bound "
          f"{bound_ms / tri_ms:.3f}; library: no single PyTorch call "
          f"computes these counts; {live} live tiles, {int(got.sum())} "
          f"gate-passing pairs; every tile bit-equal to the plain version")
    check(live > 0, "gate_counts: no live tile in the 524,288-row triangle")
    return dict(max_abs_err=err, ms=tri_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                ms_second_turn=tri_ms2, tiles=n_tiles,
                launch_tiles=screened.GATE_LAUNCH_TILES,
                chunk_tiles=GATE_PLAIN_CHUNK, chunk_ms=chunk_ms,
                plain_chunk_ms=plain_ms / len(plain_tiles),
                live_tiles=live, pairs_passing=int(got.sum()))


def pooled_oracle(hostref, regs, e, **kw):
    """A p=14 PairOracle for oracle_all_pairs: each batch's native union
    histograms on one thread, since the pool's threads are the
    parallelism (the library's own threads would oversubscribe the
    cores)."""
    from cuda_selection_criteria_tpu_torch.native import fastx
    return hostref.PairOracle(
        14, regs, e, hist_fn=lambda ii, kk: fastx.pair_union_hist(
            regs, ii, kk, threads=1), **kw)


def oracle_all_pairs(oracle, n, threads=8):
    """PairOracle.confirm_pairs over every i<k pair of n sorted rows, in
    slices over a thread pool (the native histograms and most of numpy's
    MLE release the interpreter lock): [(i, k, jacc)] in pair order."""
    ii, kk = np.triu_indices(n, 1)
    step = -(-len(ii) // (4 * threads))
    with ThreadPoolExecutor(threads) as pool:
        parts = pool.map(lambda c: oracle.confirm_pairs(
            zip(ii[c:c + step], kk[c:c + step])), range(0, len(ii), step))
        return [x for part in parts for x in part]


def all_pairs_lines(hostref, format_results, fbank, **kw):
    """The host reference's output lines for `fbank`: PairOracle.
    confirm_pairs (kw: criterion, tau, apply_cb) over every i<k pair of
    the sorted bank on the pool, the same f64 cascade as select_pairs_host
    (tests/test_torch_hostref.py holds them equal) without its 2.1M scalar
    MLE loops at N=2048."""
    order = fbank.sorted_by_cardinality()
    oracle = pooled_oracle(
        hostref, fbank.regs[order], np.trunc(fbank.cards[order]),
        aux=None if fbank.aux is None else fbank.aux[order],
        aux_param=fbank.aux_param, **kw)
    names = fbank.names
    return format_results([(names[order[i]], names[order[k]], j)
                           for i, k, j in oracle_all_pairs(oracle, fbank.n)])


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


def verify_pairs(hostref, bank, pairs, out, crit):
    """Every emitted pair is oracle-confirmed with the identical Jaccard;
    every planted pair (i, j) (bank indices) that the exact oracle passes
    is emitted. Returns the number of planted pairs the oracle passes."""
    order = bank.sorted_by_cardinality()
    pos = np.empty_like(order)
    pos[order] = np.arange(len(order))
    oracle = hostref.PairOracle(
        bank.p, bank.regs[order], np.trunc(bank.cards[order]),
        aux=None if bank.aux is None else bank.aux[order],
        aux_param=bank.aux_param, criterion=crit, tau=0.9,
        apply_cb=crit not in ("baseline", "smh_only"))
    name_pos = {name: pos[i] for i, name in enumerate(bank.names)}
    emitted = {}
    for a, b, j in out:
        sel, j_exact = oracle.evaluate(name_pos[a], name_pos[b])
        check(sel and j == j_exact, f"emitted pair {a} {b} not confirmed")
        emitted[(a, b)] = j
    planted_pass = 0
    for i, k in pairs:
        lo, hi = sorted((pos[i], pos[k]))
        if oracle.evaluate(lo, hi)[0]:
            planted_pass += 1
            check((bank.names[order[lo]], bank.names[order[hi]]) in emitted,
                  f"planted pair {i} {k} passes the oracle but was not "
                  "emitted")
    print(f"  planted pairs passing the exact oracle: {planted_pass} of "
          f"{len(pairs)}, all emitted; {len(out)} emitted, all confirmed")
    check(planted_pass > 0, "no planted pair passes the oracle")
    return planted_pass


def run_main_path(torch, screen, select_pairs, bank, params, dev, card):
    """One select_pairs run on the card with the launch counts set to 0
    just before it: (pairs, {kernel: launches})."""
    reset_launches(screen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    out = select_pairs(bank, params, device=dev, stats=stats)
    wall = time.perf_counter() - t0
    launches = read_launches(screen)
    print(f"  [{card}] select_pairs -c {params.criterion} wall {wall:.3f} s: "
          f"plan {stats['plan_secs']:.3f} s, schedule "
          f"{stats['schedule_secs']:.4f} s, prune {stats['prune_secs']:.3f} "
          f"s, screen {stats['screen_secs']:.3f} s, confirm "
          f"{stats['confirm_secs']:.3f} s; tiles {stats['tiles_scheduled']} "
          f"scheduled / {stats['tiles_live']} live, {stats['candidates']} "
          f"candidates, {len(out)} pairs, K1 launches "
          f"{launches['screen_fused']}, K2 launches "
          f"{launches['weighted_cdf_sum']}, gate_counts launches "
          f"{launches['gate_counts']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return out, launches


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


def write_corpus(d, seed, n_base=96, len_range=(5e5, 6e6)):
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


def max_abs_diff(a, b):
    """Largest |a - b| over two equal-shape integer arrays, exact for
    uint64 (0 when bit-equal)."""
    a, b = a.reshape(-1), b.reshape(-1)
    return max((abs(int(a[i]) - int(b[i])) for i in np.nonzero(a != b)[0]),
               default=0)


def build_card_vs_cpu(torch, bank_mod, files, tmp, dev, card):
    """build_bank_from_files on the card against the same call on the CPU
    for the subset `files`: bank arrays bit-equal, written sketch files
    byte-identical. Returns the largest |difference| (must be 0)."""
    worst = fallbacks = 0
    for crit, aux_bytes in (("smh_a", 256), ("hll_a", 256), ("smh_a", 4096)):
        kind, param = bank_mod.aux_spec(crit, aux_bytes)
        out = {}
        for where in ("cuda", "cpu"):
            d = os.path.join(tmp, f"cmp_{crit}_{aux_bytes}_{where}")
            os.makedirs(d)
            linked = [os.path.join(d, os.path.basename(f)) for f in files]
            for f, g in zip(files, linked):
                os.link(f, g)
            st = {}
            t0 = time.perf_counter()
            bank = bank_mod.build_bank_from_files(
                linked, crit, aux_bytes, backend="device",
                device=dev if where == "cuda" else "cpu", stats=st)
            secs = time.perf_counter() - t0
            bank.write_sketch_files()
            out[where] = (bank, linked, st, secs)
        (cb, cf, cst, csecs), (pb, pf, _, psecs) = out["cuda"], out["cpu"]
        err = max(max_abs_diff(cb.regs, pb.regs), max_abs_diff(cb.aux, pb.aux))
        sfx = [".hll", f".hll_{param}" if kind == "hll" else f".smh{param}"]
        same = all(filecmp.cmp(a + x, b + x, shallow=False)
                   for a, b in zip(cf, pf) for x in sfx)
        print(f"  [{card}] build -c {crit} -a {aux_bytes} ({kind} {param}; "
              f"backend {cst['backend']}, decoder {cst['decoder']}, threads "
              f"{cst['io_threads']}), {len(files)} files, {cst['codes']} "
              f"codes: card "
              f"{csecs:.2f} s, cpu {psecs:.2f} s; {cst['packs']} packs, "
              f"{cst['chunked_genomes']} chunked, {cst['smh_fallbacks']} "
              f"SMH fallbacks; max_abs_err={err}; files identical: {same}")
        check(err == 0, f"build -c {crit} -a {aux_bytes}: card != cpu")
        check(same, f"build -c {crit} -a {aux_bytes}: file bytes differ")
        worst = max(worst, err)
        fallbacks += cst["smh_fallbacks"]
    check(fallbacks > 0, "the subset never took the SMH full fallback")
    return worst


def device_profile(torch, fn, card, label, top=10):
    """One torch.profiler trace of fn() (warm: the caller has run it
    before): wall, device busy time, the device's idle share and the top
    device items."""
    from cuda_selection_criteria_tpu_torch.utils.profiling import (
        device_trace)

    torch.cuda.synchronize()
    with device_trace() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries only (kernels, copies, fills): a CPU op's
    # device time repeats that of the kernels it launched
    cpu = torch.autograd.DeviceType.CPU
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages() if e.device_type != cpu
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"  [{card}] profiled {label}: wall {wall_us / 1e3:.3f} ms "
          f"(profiler on), device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall_us:.3f}")
    for us, key, count in rows[:top]:
        print(f"    {us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")
    if not busy:
        print("  the profiler recorded no device time")


def profile_pack(torch, bank_mod, fasta, files, dev, card):
    """One torch.profiler trace of one warm pack of the smallest genomes
    (-c smh_a -a 256: k-mers, hashes, both scatters, the SMH j=0 pass and
    the fetch): top device ops and the device's idle share."""
    sizes = sorted((os.path.getsize(f), f) for f in files
                   if f.endswith(".gz"))
    budget = bank_mod.SMH_CANDIDATES // 32
    pack, used = [], 0
    for _, f in sizes:
        codes = fasta.fasta_codes(f)
        if used + codes.size > budget or len(pack) == bank_mod.PACK_GENOMES:
            break
        pack.append((len(pack), codes))
        used += codes.size

    def one():
        regs, aux = bank_mod._sketch_pack_device(pack, 31, 14, "smh", 32,
                                                 dev)
        return regs.cpu(), aux.cpu()

    one()
    device_profile(torch, one, card, f"warm pack ({len(pack)} genomes, "
                   f"{used} codes)")
    print(f"  [{card}] the same pack, profiler off: "
          f"{cuda_ms(torch, one, 5):.3f} ms per pack (CUDA events)")


class LineLog(io.TextIOBase):
    """A stdout that records, for each line written, the value of
    `probe()` when the line ended."""

    def __init__(self, probe):
        self.probe, self.buf, self.lines = probe, "", []

    def write(self, s):
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.lines.append((line, self.probe()))
        return len(s)


def sketch_bytes(files, crit):
    """{path: bytes} of the sketch files build_sketch -c crit -a 256 wrote
    next to `files`."""
    out = {}
    for f in files:
        for sfx in (".hll", ".smh32" if crit == "smh_a" else ".hll_8"):
            with open(f + sfx, "rb") as fh:
                out[f + sfx] = fh.read()
    return out


@contextlib.contextmanager
def python_decoder(fasta):
    """utils/fasta with the native reader switched off, as the port was
    before it had one: the device pipeline decodes with fasta_codes_py on
    one thread."""
    saved = fasta.fasta_codes, fasta.decoder
    fasta.fasta_codes, fasta.decoder = fasta.fasta_codes_py, lambda: "python"
    try:
        yield
    finally:
        fasta.fasta_codes, fasta.decoder = saved


def run_build(build_sketch, lst, crit, backend, dev):
    """build_sketch -a 256 -c crit -t 8 --backend backend: (stats, wall)."""
    st = {}
    t0 = time.perf_counter()
    check(build_sketch.main(["-l", lst, "-a", "256", "-c", crit, "-t", "8",
                             "--backend", backend, "--device", str(dev)],
                            stats=st) == 0,
          f"build_sketch -c {crit} --backend {backend} failed")
    return st, time.perf_counter() - t0


def build_label(crit, st):
    return (f"build_sketch -c {crit} -a 256 -t 8 --backend {st['backend']} "
            f"(decoder {st['decoder']}, threads {st['io_threads']})")


def phase_fasta(torch, dev, card, corpus_kw, tmp_dir):
    """Phase 7: FASTA -> build_sketch -> selection and time_smh on a
    synthetic bacterial corpus written under tmp_dir (phase 10 times the
    reference's sweep on it). Returns ({kernel: launches on the
    selection runs}, max |card - cpu| of the build, the corpus's file
    list)."""
    from cuda_selection_criteria_tpu_torch import models
    from cuda_selection_criteria_tpu_torch.cli import build_sketch
    from cuda_selection_criteria_tpu_torch.cli import selection as cli
    from cuda_selection_criteria_tpu_torch.cli import time_smh
    from cuda_selection_criteria_tpu_torch.models import bank as bank_mod
    from cuda_selection_criteria_tpu_torch.native import fastx
    from cuda_selection_criteria_tpu_torch.ops import screen
    from cuda_selection_criteria_tpu_torch.parallel.selection import (
        format_results)
    from cuda_selection_criteria_tpu_torch.utils import fasta, hostref

    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    with contextlib.nullcontext(tmp_dir) as tmp:
        t0 = time.perf_counter()
        files, near, far, bases = write_corpus(tmp, **corpus_kw)
        print(f"  corpus: {len(files)} files ({len(files) - 28} genomes, 16 "
              f"copies at SNP rate 0.001, 8 at 0.02, 4 tiny FASTQ), {bases} "
              f"bases, {sum(map(os.path.getsize, files)) / 2**20:.1f} MiB "
              f"gz, written in {time.perf_counter() - t0:.1f} s (host)")
        lst = os.path.join(tmp, "list.txt")
        with open(lst, "w") as fh:
            fh.write("\n".join(files) + "\n")

        # the first files are the base genomes; 24 copies and 4 FASTQs follow
        by_size = sorted(range(len(files) - 28),
                         key=lambda i: -os.path.getsize(files[i]))
        subset = ([files[i] for i in by_size[:2]]
                  + [files[c] for _, c in near[:2]] + files[-4:])
        build_err = build_card_vs_cpu(torch, bank_mod, subset, tmp, dev, card)

        sub = files[:16]
        sub_lst = os.path.join(tmp, "subset.txt")
        with open(sub_lst, "w") as fh:
            fh.write("\n".join(sub) + "\n")
        secs = {"native": 0.0, "python": 0.0}
        sub_codes = 0
        for f in sub:
            t0 = time.perf_counter()
            got = fastx.fasta_codes(f)
            secs["native"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            want = fasta.fasta_codes_py(f)
            secs["python"] += time.perf_counter() - t0
            check(np.array_equal(got, want), f"native decode of {f} differs")
            sub_codes += want.size
        print(f"  [{card}] decode on one host thread, {len(sub)} files, "
              f"{sub_codes} codes: native {sub_codes / secs['native']:.4g} "
              f"codes/s ({secs['native']:.2f} s), Python "
              f"{sub_codes / secs['python']:.4g} codes/s "
              f"({secs['python']:.2f} s): "
              f"{secs['python'] / secs['native']:.2f}x, codes bit-equal")

        walls = {}
        for crit in ("smh_a", "hll_a"):
            st, walls[crit] = run_build(build_sketch, lst, crit, "device",
                                        dev)
            print(f"  [{card}] {build_label(crit, st)}: {st['genomes']} "
                  f"files, {st['codes']} codes in {walls[crit]:.2f} s = "
                  f"{st['codes'] / walls[crit]:.4g} codes/s; decode wait "
                  f"{st['decode_secs']:.2f} s (decode threads busy "
                  f"{st['decode_busy_secs']:.2f} s), "
                  f"pack {st['pack_secs']:.2f} s ({st['packs']} packs), "
                  f"chunked {st['chunked_secs']:.2f} s "
                  f"({st['chunked_genomes']} genomes), fetch "
                  f"{st['fetch_secs']:.3f} s, {st['smh_fallbacks']} SMH "
                  f"fallbacks")
            check(st["decoder"] == "native", "the build did not decode with "
                  "the native reader")
            want = sketch_bytes(files, crit)
            nst, wall = run_build(build_sketch, lst, crit, "native", dev)
            same = sketch_bytes(files, crit) == want
            print(f"  [{card}] {build_label(crit, nst)}: {nst['genomes']} "
                  f"files in {wall:.2f} s = {st['codes'] / wall:.4g} codes/s "
                  f"({walls[crit] / wall:.2f}x the device pipeline's); "
                  f"files identical to its: {same}")
            check(same, f"-c {crit}: native backend's files differ")
            sub_want = sketch_bytes(sub, crit)
            for decoder in ("native", "python"):
                with (python_decoder(fasta) if decoder == "python"
                      else contextlib.nullcontext()):
                    sst, wall = run_build(build_sketch, sub_lst, crit,
                                          "device", dev)
                same = sketch_bytes(sub, crit) == sub_want
                print(f"  [{card}] subset {build_label(crit, sst)}: "
                      f"{sst['genomes']} files, {sst['codes']} codes in "
                      f"{wall:.2f} s = {sst['codes'] / wall:.4g} codes/s; "
                      f"decode wait {sst['decode_secs']:.2f} s (decode "
                      f"threads busy {sst['decode_busy_secs']:.2f} s), pack "
                      f"{sst['pack_secs']:.2f} s, chunked "
                      f"{sst['chunked_secs']:.2f} s "
                      f"({sst['chunked_genomes']} genomes); files "
                      f"identical: {same}")
                check(sst["decoder"] == decoder, f"decoder {sst['decoder']}")
                check(same, f"-c {crit} subset ({decoder} decoder): files "
                      "differ")
        profile_pack(torch, bank_mod, fasta, files, dev, card)

        pair_names = [{files[b], files[c]} for b, c in far]
        for crit in ("smh_a", "smh_only", "cb", "hll_a", "hll_an"):
            reset_launches(screen)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["-l", lst, "-a", "256", "-h", "0.9", "-c",
                               crit, "--device", str(dev)])
            t_cli = time.perf_counter() - t0
            got = read_launches(screen)
            check(rc == 0, f"selection -c {crit} exit {rc}")
            fbank = models.SketchBank.from_sketch_files(
                files, criterion={"smh_only": "smh_a", "cb": None}.get(
                    crit, crit))
            host = hostref.select_pairs_host(
                fbank, 0.9, crit, apply_cb=crit not in ("baseline",
                                                        "smh_only"))
            lines = buf.getvalue().splitlines()
            print(f"  [{card}] FASTA -> pairs -c {crit}: {len(lines)} lines "
                  f"in {t_cli:.2f} s (selection CLI; the build above took "
                  f"{walls['hll_a' if crit.startswith('hll') else 'smh_a']:.2f}"
                  f" s), K1 launches {got['screen_fused']}, K2 launches "
                  f"{got['weighted_cdf_sum']}")
            check(lines == format_results(host),
                  f"-c {crit} differs from select_pairs_host")
            passed = verify_pairs(hostref, fbank, near, host, crit)
            if crit == "smh_a":
                check(passed >= 12, f"only {passed} of 16 SNP-0.001 pairs "
                      "pass the exact smh_a oracle")
            check(not any({a, b} in pair_names for a, b, _ in host),
                  f"-c {crit} emitted a SNP-0.02 copy")
            check(got["screen_fused"] > 0, f"-c {crit} never launched K1")
            if crit.startswith("hll"):
                check(got["weighted_cdf_sum"] > 0,
                      f"-c {crit} never launched K2")
            for name in launches:
                launches[name] += got[name]

        log = LineLog(lambda: screen.screen_hits_fused.launches)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = time_smh.main(["-l", lst, "-m", "32", "-R", "1",
                                "--device", str(dev)])
        check(rc == 0, f"time_smh exit {rc}")
        rows = [line.split(";") for line, _ in log.lines]
        kinds = [r[1] for r in rows]
        print(f"  [{card}] time_smh -m 32 -R 1 in "
              f"{time.perf_counter() - t0:.2f} s:")
        for line, _ in log.lines:
            print("    " + line.replace(tmp, "<tmp>"))
        check(kinds == ["build_smh", "smh_a", "CB+smh_a", "smh_a_kernel",
                        "CB+smh_a_kernel"], f"time_smh rows {kinds}")
        for r in rows:
            check(len(r) == 5 and r[0] == lst and r[2] == "0.9"
                  and float(r[3]) >= 0.0, f"malformed time_smh row {r}")
        check(rows[0][4] == "m:32" and all(
            r[4].startswith("r:") and "_b:" in r[4] for r in rows[1:]),
            "time_smh row tails")
        k1_row = log.lines[3][1] - log.lines[2][1]
        print(f"  K1 launches in the smh_a_kernel row: {k1_row}")
        check(k1_row > 0, "time_smh's smh_a_kernel row never launched K1")
    return launches, build_err, lst


def cli_lines(cli, argv):
    """The selection CLI's output lines and its wall seconds."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"selection {' '.join(argv[4:])} exit {rc}")
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def phase_dense_cli(models, cli, hostref, format_results, names, lst, ref4,
                    dev, card):
    """Phase 8, step 1: the selection CLI with --engine dense on phase 4's
    N=2048 files for every criterion, against the host reference lines
    (phase 4's, and for smh_only the vectorized oracle over all pairs) and
    the screened engine's lines (phase 4 held them equal to the same
    reference; smh_only runs here)."""
    base = ["-l", lst, "-a", "256", "-h", "0.9", "--device", str(dev)]
    ref4["smh_only"] = all_pairs_lines(
        hostref, format_results,
        models.SketchBank.from_sketch_files(names, criterion="smh_a"),
        criterion="smh_only", tau=0.9, apply_cb=False)
    got, _ = cli_lines(cli, base + ["-c", "smh_only", "--engine",
                                    "screened"])
    check(got == ref4["smh_only"], "screened -c smh_only differs from the "
          "host reference")
    for crit, precision in (("smh_a", "bf16"), ("smh_a", "int8"),
                            ("smh_only", "bf16"), ("cb", "bf16"),
                            ("baseline", "bf16"), ("hll_a", "bf16"),
                            ("hll_an", "bf16")):
        got, secs = cli_lines(cli, base + [
            "-c", crit, "--engine", "dense", "--precision", precision])
        print(f"  [{card}] --engine dense --precision {precision} -c {crit}:"
              f" {len(got)} lines in {secs:.2f} s, equal to the host "
              f"reference and the screened engine: {got == ref4[crit]}")
        check(got == ref4[crit], f"dense -c {crit} ({precision}) differs "
              "from the host reference")


def phase_dense_main(torch, mods, bank, picks, crit, dev, card):
    """Phase 8, step 2: select_pairs(engine="dense") on a phase 5 / 6 bank
    with the checks of phase 5; wall and stage split beside the screened
    engine's warm wall on the same bank, and one tile's parts timed alone
    (CUDA events): the union histograms on both routes, the MLE, and for
    hll_a the aux union and aux MLE at p_aux."""
    screen, pairwise, estimators = mods["screen"], mods["pairwise"], \
        mods["estimators"]
    params = mods["SelectionParams"](tau=0.9, criterion=crit, engine="dense")
    screen.screen_hits_fused.launches = 0
    screen.screen_s_z.launches = 0
    torch.cuda.synchronize()
    stats = {}
    t0 = time.perf_counter()
    out = mods["select_pairs"](bank, params, device=dev, stats=stats)
    wall = time.perf_counter() - t0
    k_launches = (screen.screen_hits_fused.launches,
                  screen.screen_s_z.launches)
    verify_pairs(mods["hostref"], bank, [(i, i + 1) for i in picks], out,
                 crit)
    sparams = mods["SelectionParams"](tau=0.9, criterion=crit)
    mods["select_pairs"](bank, sparams, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_out = mods["select_pairs"](bank, sparams, device=dev)
    s_wall = time.perf_counter() - t0
    check(out == s_out, f"dense -c {crit} != screened at N={bank.n}")
    tile_ms = stats["tile_secs"] / stats["tiles"] * 1e3
    print(f"  [{card}] select_pairs -c {crit} --engine dense N={bank.n}: "
          f"wall {wall:.3f} s (plan {stats['plan_secs']:.3f} s, tiles "
          f"{stats['tile_secs']:.3f} s, confirm {stats['confirm_secs']:.3f}"
          f" s); {stats['tiles']} tiles of 512 x 512, {tile_ms:.3f} ms a "
          f"tile; {stats['candidates']} candidates, {len(out)} pairs, equal "
          f"to the screened engine's (warm wall {s_wall:.3f} s, "
          f"{wall / s_wall:.1f}x); K1 / K2 launches {k_launches}")

    order = bank.sorted_by_cardinality()
    rows = torch.from_numpy(bank.regs[order[:1024]]).to(dev)
    ra, rb = rows[:512], rows[512:]
    split = {}
    for precision in ("bf16", "int8"):
        split[f"union_{precision}"] = cuda_ms(
            torch, lambda: pairwise.union_histograms(ra, rb, 14, precision),
            3)
    h32 = pairwise.union_histograms(ra, rb, 14)
    check(torch.equal(h32, pairwise.union_histograms(ra, rb, 14, "int8")),
          "union histograms: the int8 and f32 routes differ")
    split["mle"] = cuda_ms(torch, lambda: estimators.ertl_mle(
        h32, 14, dtype=torch.float32), 3)
    if crit.startswith("hll"):
        aux = torch.from_numpy(bank.aux[order[:1024]]).to(dev)
        split["aux_union"] = cuda_ms(torch, lambda: pairwise.union_histograms(
            aux[:512], aux[512:], bank.aux_param), 3)
        ha = pairwise.union_histograms(aux[:512], aux[512:], bank.aux_param)
        split["aux_mle"] = cuda_ms(torch, lambda: estimators.ertl_mle(
            ha, bank.aux_param, dtype=torch.float32), 3)
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
    alone = sum(v for k, v in split.items() if k != "union_int8")
    print(f"  [{card}] one 512 x 512 tile's parts alone: {parts}; the parts "
          f"the engine runs sum to {alone:.3f} ms, against {tile_ms:.3f} ms "
          f"a tile in the engine's run")
    return dict(wall=wall, screened_wall=s_wall, tile_ms=tile_ms, **split)


def phase_dense_mle(torch, estimators, hostref, banks, dev, card):
    """Phase 8, step 3: the card's f64 ERTL-MLE against the host oracle's
    (hostref.ertl_mle_batch) over 2^16 pair-union histograms at p=14 from
    the given banks, in ulp, and the f32 MLE's largest relative error;
    then 4096 histograms whose secant start takes the log1p branch."""
    rng = np.random.default_rng(0x3E7)
    per = (1 << 16) // len(banks)
    hists = np.concatenate([hostref.pair_union_histograms_np(
        regs, *rng.integers(0, len(regs), size=(2, per))) for regs in banks])
    q, m = 50, 1 << 14
    deg = np.zeros((4096, 64), np.int64)
    deg[:, q] = rng.integers(1, m // 3, 4096)
    deg[:, q - 1] = rng.integers(0, 3, 4096)
    deg[:, q + 1] = m - deg[:, q] - deg[:, q - 1]
    res = {}
    for label, h in (("pair unions", hists), ("log1p branch", deg)):
        want = hostref.ertl_mle_batch(h, 14)
        d = torch.from_numpy(h).to(dev)
        got = estimators.ertl_mle(d, 14).cpu().numpy()
        f32 = estimators.ertl_mle(d, 14, dtype=torch.float32).cpu().numpy()
        ulps = np.where(got == want, 0,
                        np.abs(got.view(np.int64) - want.view(np.int64)))
        fin = np.isfinite(want) & (want > 0)
        rel = float(np.abs(f32[fin] / want[fin] - 1.0).max())
        print(f"  [{card}] f64 ertl_mle on the card vs ertl_mle_batch, "
              f"{len(h)} {label} histograms: max {int(ulps.max())} ulp, "
              f"{int((ulps > 0).sum())} differ; f32 ertl_mle largest "
              f"relative error {rel:.3g} (screen_margin 1e-4)")
        check(rel <= 1e-5, f"f32 MLE error {rel} above 1e-5")
        res[label] = (int(ulps.max()), rel)
    check(res["pair unions"][0] <= 2, "the card's f64 MLE is more than 2 ulp "
          "from the host oracle's on pair unions")
    check(res["log1p branch"][0] <= 4, "the card's f64 MLE is more than 4 "
          "ulp from the host oracle's on the log1p branch")
    return res


def phase_checkpoint(torch, screen, screened, bank, params, dev, card):
    """Phase 8, step 4: phase 5's smh_a sweep with a checkpoint file (chunks
    of 8 tiles, so several spans); the file cut to its header, two records
    and a torn line; the resumed run gives the same pairs with fewer K1
    launches."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweep.jsonl")
        runs = []
        for ckpt in (None, path, path):
            screen.screen_hits_fused.launches = 0
            out = screened.select_pairs_screened(bank, params, chunk=8,
                                                 device=dev, checkpoint=ckpt)
            runs.append((out, screen.screen_hits_fused.launches))
            if ckpt is not None and len(runs) == 2:
                with open(path) as fh:
                    lines = fh.read().splitlines()
                with open(path, "w") as fh:
                    fh.write("\n".join(lines[:3]) + '\n{"span": [99')
    (plain, n0), (first, n1), (resumed, n2) = runs
    print(f"  [{card}] checkpointed smh_a sweep: {len(lines) - 1} spans "
          f"recorded, K1 launches {n0} plain / {n1} with the file / {n2} "
          f"resumed from 2 records and a torn line; pairs equal: "
          f"{plain == first == resumed}")
    check(plain == first == resumed, "a checkpointed sweep changed the pairs")
    check(len(lines) - 1 == n0 == n1 and n2 == n0 - 2,
          "the resumed sweep did not skip the recorded spans")


LAUNCH_KEYS = ("screen_fused", "strips", "weighted_cdf_sum", "gate_counts")


def reset_launches(screen):
    for fn in (screen.screen_hits_fused, screen.screen_hits_fused_strips,
               screen.screen_s_z, screen.gate_counts):
        fn.launches = 0


def read_launches(screen):
    """{kernel: launches} since reset_launches (keys LAUNCH_KEYS); K1's two
    entry points launch the same kernel, "strips" counts the strip entry
    alone."""
    return {"screen_fused": screen.screen_hits_fused.launches
            + screen.screen_hits_fused_strips.launches,
            "strips": screen.screen_hits_fused_strips.launches,
            "weighted_cdf_sum": screen.screen_s_z.launches,
            "gate_counts": screen.gate_counts.launches}


def multi_device_run(torch, screen, engine, bank, params, mesh, dev, card,
                     label, **kw):
    """One run of a multi-device engine (ring or tile-sharded) on `mesh`,
    with the launch counts set to 0 just before it: (pairs, stats,
    launches). Its walls measure the engine on virtual devices of one card,
    not multi-card scaling."""
    reset_launches(screen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    out = engine(bank, params, mesh=mesh, stats=stats, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(screen)
    split = ", ".join(f"{k[:-5]} {v:.3f} s" for k, v in stats.items()
                      if k.endswith("_secs"))
    counts = ", ".join(f"{k} {v}" for k, v in stats.items()
                       if not k.endswith("_secs"))
    print(f"  [{card}] {label} -c {params.criterion} N={bank.n} on "
          f"{len(mesh.devices())} virtual devices of one card: wall "
          f"{wall:.3f} s ({split}); {counts}; {len(out)} pairs; launches "
          f"K1 {launches['screen_fused']} (strips {launches['strips']}), K2 "
          f"{launches['weighted_cdf_sum']}, gate_counts "
          f"{launches['gate_counts']}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return out, stats, launches


def phase_multi_device(torch, mods, banks, screened_out, lst, ref4, dev,
                       card):
    """Phase 9: the multi-device engines on four virtual devices of the one
    card (a mesh that names cuda:0 four times: strips with non-zero bases,
    the same tensors rotating): the ring and the tile-sharded engine on the
    phase 5 (smh_a) and 6 (hll_a) banks, the ring on a 65536-genome bank
    within its mask-memory bound, the selection CLI's multi-device engines
    on phase 4's files, and three explicit multi-host tile slices, merged.
    Returns {engine: {kernel: launches}}, each engine's launches summed
    over its runs, each run's read right after its own reset."""
    screen, ring, screened, mesh_mod = (mods["screen"], mods["ring"],
                                        mods["screened"], mods["mesh"])
    mesh4 = mesh_mod.row_mesh(["cuda:0"] * 4)
    print(f"  mesh {mesh4}: cuda:0 four times, four virtual devices of one "
          "card")
    total = {engine: dict.fromkeys(LAUNCH_KEYS, 0)
             for engine in ("ring", "sharded")}

    def add(engine, launches):
        for k in total[engine]:
            total[engine][k] += launches[k]

    for crit in ("smh_a", "hll_a"):
        bank, picks = banks[crit]
        params = mods["SelectionParams"](tau=0.9, criterion=crit)
        out, stats, lr = multi_device_run(
            torch, screen, ring.select_pairs_ring, bank, params, mesh4, dev,
            card, "ring")
        check(lr["strips"] > 0, f"ring -c {crit} never launched K1's strip "
              "variant")
        check(lr["gate_counts"] > 0, f"ring -c {crit} never launched the "
              "gate-count kernel")
        check(crit == "smh_a" or lr["weighted_cdf_sum"] > 0,
              f"ring -c {crit} never launched K2")
        check(stats["steps_run"] > 1, f"ring -c {crit} ran one step only")
        mods["verify_pairs"](bank, [(i, i + 1) for i in picks], out, crit)
        check(out == screened_out[crit], f"ring -c {crit} != the screened "
              "engine's pairs")
        add("ring", lr)
        out, _, ls = multi_device_run(
            torch, screen, screened.select_pairs_screened_sharded, bank,
            params, mesh4, dev, card, "tile-sharded")
        check(ls["screen_fused"] > 0, f"sharded -c {crit} never launched K1")
        check(ls["gate_counts"] > 0, f"sharded -c {crit} never launched the "
              "gate-count kernel")
        check(crit == "smh_a" or ls["weighted_cdf_sum"] > 0,
              f"sharded -c {crit} never launched K2")
        mods["verify_pairs"](bank, [(i, i + 1) for i in picks], out, crit)
        check(out == screened_out[crit], f"sharded -c {crit} != the screened "
              "engine's pairs")
        add("sharded", ls)

    t0 = time.perf_counter()
    big, big_picks = mods["bench_bank"](65536, np.random.default_rng(0x65536),
                                        600)
    print(f"  bench bank N=65536 p=14 (1 GiB of registers, strips of 256 "
          f"MiB) with {len(big_picks)} planted pairs made in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    params = mods["SelectionParams"](tau=0.9, criterion="smh_a")
    # one chunk a wave: each of the four positions holds at most one
    # launch's masks when the counts are read
    out, stats, lr = multi_device_run(torch, screen, ring.select_pairs_ring,
                                      big, params, mesh4, dev, card, "ring",
                                      wave=1)
    peak = torch.cuda.max_memory_allocated()
    ti = screened.auto_tile(big.n // 4)
    launch_bytes = stats["chunk_tiles"] * ti * ti
    bank_bytes = big.n * (1 << big.p)
    print(f"  ring N=65536, wave 1: masks held by one position at a read "
          f"{stats['max_device_mask_bytes']} bytes (bound wave * chunk_tiles "
          f"* ti^2 = {launch_bytes}); the card's allocator at a read, beyond "
          f"the step loop's start: {stats['max_wave_alloc_bytes']} bytes "
          f"(bound 4 positions * {launch_bytes} + 1 MiB of counts and tile "
          f"ids); peak allocated over the whole run {peak} bytes = registers "
          f"{bank_bytes} + {peak - bank_bytes} (uploads, gate pass, K1 "
          "planes, confirm)")
    check(stats["max_device_mask_bytes"] <= launch_bytes,
          "ring N=65536: a position held more than one wave of masks")
    check(stats["max_wave_alloc_bytes"] <= 4 * launch_bytes + (1 << 20),
          "ring N=65536: the card held more than the four positions' masks "
          "at a read")
    check(lr["strips"] > 0, "ring N=65536 never launched K1's strips")
    mods["verify_pairs"](big, [(i, i + 1) for i in big_picks], out, "smh_a")
    t0 = time.perf_counter()
    single = mods["select_pairs"](big, params, device=dev)
    print(f"  [{card}] screened engine N=65536 on the card itself: "
          f"{time.perf_counter() - t0:.3f} s, {len(single)} pairs")
    check(out == single, "ring N=65536 != the screened engine's pairs")
    add("ring", lr)
    del big

    base = ["-l", lst, "-a", "256", "-h", "0.9", "--device", "cuda"]
    for crit, flags in (("smh_a", ["--engine", "ring"]),
                        ("hll_a", ["--engine", "ring"]),
                        ("smh_a", ["--engine", "sharded"]),
                        ("hll_an", ["--engine", "sharded"]),
                        ("cb", ["--sharded"]),
                        ("smh_a", ["--engine", "dense-sharded"]),
                        ("hll_a", ["--engine", "dense-sharded"])):
        got, secs = cli_lines(mods["cli"], base + ["-c", crit] + flags)
        print(f"  [{card}] selection {' '.join(flags)} -c {crit} (every "
              f"CUDA device: {torch.cuda.device_count()}): {len(got)} lines "
              f"in {secs:.2f} s, equal to the host reference: "
              f"{got == ref4[crit]}")
        check(got == ref4[crit], f"selection {' '.join(flags)} -c {crit} "
              "differs from the host reference")

    bank, _ = banks["smh_a"]
    params = mods["SelectionParams"](tau=0.9, criterion="smh_a")
    t0 = time.perf_counter()
    shards = [mods["distributed"].select_pairs_multihost(
        bank, params, ti=1024, device=dev, process_index=i, process_count=3)
        for i in range(3)]
    merged = mods["distributed"].merge_multihost_results(shards)
    print(f"  [{card}] select_pairs_multihost, 3 explicit slices of the "
          f"phase 5 bank: {[len(x) for x in shards]} pairs, merged "
          f"{len(merged)} in {time.perf_counter() - t0:.3f} s, equal to the "
          f"screened engine's: {merged == screened_out['smh_a']}")
    check(merged == screened_out["smh_a"],
          "merged multi-host slices != the screened engine's pairs")
    return total


# Phase 10a's prefix of phase 4's files: the scalar host engine's three
# runs at tau=0.01 (every CB-live pair through a Python MLE loop) set its
# wall, which grows as the square of the prefix: 93.8 s at 512 files and
# 70.5 s at 384 on the host of an NVIDIA H100 80GB HBM3 (700 W), and 67.0
# s at 352 on a slower one, so about 35 s there at 256. Phase 10c's pairs,
# each protocol: its two rates took 44.6 s at 2^20 pairs on that slower
# host. Both are cut so that the whole script stays under 10 minutes on
# it.
L5_PREFIX = 256
L5_PAIRS = 1 << 19


def launch_sum(total, got):
    for name in total:
        total[name] += got[name]


def host_profile(fn, card, label, top=8):
    """fn() under cProfile: its wall and the functions with the most own
    time (a builtin, numpy or torch call is an entry of its own; a ctypes
    call into libfastx counts as its Python caller's own time)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    rows = sorted(((v[2], v[3], v[0], k) for k, v in st.stats.items()),
                  reverse=True)
    print(f"  [{card}] host profile of {label}: wall {wall:.3f} s "
          f"(cProfile on); own time, cumulative, calls:")
    for tt, ct, calls, (path, line, name) in rows[:top]:
        print(f"    {tt:8.3f} s {ct:8.3f} s {calls:7d}x  "
              f"{os.path.basename(path)}:{line}({name})")


def baseline_breakdown(torch, mods, fbank, tau, dev, card):
    """Where selection -c baseline -h tau's time goes on phase 4's bank:
    K1's launch over the schedule (CUDA events), a torch.profiler trace of
    the warm select_pairs run (device busy time, idle share, top device
    items), and cProfile of the screen stage (K1, hit extraction, the
    candidate list) and of the confirm (device histograms, host MLE)."""
    screened = mods["screened"]
    params = mods["SelectionParams"](tau=tau, criterion="baseline")
    plan = screened.ScreenPlan(fbank, params, screened.auto_tile(fbank.n),
                               device=dev)
    rows, cols = plan.schedule()
    k1_ms = cuda_ms(torch, lambda: plan.screen_chunk(rows, cols), 3)
    print(f"  [{card}] K1 over the {len(rows)} scheduled tiles of "
          f"{plan.ti} (one launch): {k1_ms:.3f} ms")
    device_profile(torch, lambda: mods["select_pairs"](fbank, params,
                                                        device=dev),
                   card, f"warm select_pairs -c baseline -h {tau} "
                   f"N={fbank.n}", top=6)
    box = {}
    host_profile(lambda: box.update(cand=plan.screen_tiles(rows, cols)),
                 card, f"the screen stage (screen_tiles, "
                 f"{len(rows)} tiles)")
    host_profile(lambda: plan.confirm(box["cand"]), card,
                 f"the confirm stage ({len(box['cand'])} candidates)")


def phase_l5(torch, mods, names4, lst4, ref4, lst7, bank, picks, dev, card):
    """Phase 10: the reference's experiment protocols on the card (layer L5,
    cuda_selection_criteria_tpu_torch/experiments). 10a the differential at
    tau=0.01 on a prefix of phase 4's files (smh_a, hll_a, baseline against
    the scalar host engine) and selection -c baseline -h 0.01 on all of
    them against the pooled oracle; 10b the timing sweep on phase 7's
    corpus, both arms; 10c the confirm stage's rates on the phase 5 bank
    with 2^19 pairs, the default and the reject protocol. Returns
    {kernel: launches} of the phase."""
    from cuda_selection_criteria_tpu_torch.experiments import (
        compare_engines, confirm_throughput, run_time_experiment)

    screen, hostref, cli = mods["screen"], mods["hostref"], mods["cli"]
    fmt = mods["format_results"]
    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    out_dir = os.path.dirname(lst4)

    print(f"  10a: the differential at tau=0.01 on the first {L5_PREFIX} "
          f"of phase 4's files", flush=True)
    prefix = names4[:L5_PREFIX]
    in_prefix = set(prefix)
    t10a = time.perf_counter()
    for crit in ("smh_a", "hll_a", "baseline"):
        fbank = compare_engines.load_bank(prefix, crit, 256)
        reset_launches(screen)
        st = {}
        got, host = compare_engines.run_both(
            fbank, mods["SelectionParams"](tau=0.01, criterion=crit), dev,
            stats=st)
        got_l = read_launches(screen)
        rows, n_bad = compare_engines.compare_rows(got, host)
        compare_engines.write_rows(
            os.path.join(out_dir, f"comparacion_cuda_host_{crit}.csv"), rows,
            dev)
        deltas = compare_engines.estimator_deltas(fbank, host, dev)
        print(f"  [{card}] compare_engines -c {crit} -t 0.01 N={fbank.n}: "
              f"pairs={len(rows)} mismatches={n_bad}; device select_pairs "
              f"{st['device_secs']:.3f} s ({st['candidates']} candidates "
              f"of {fbank.n * (fbank.n - 1) // 2} pairs, screen "
              f"{st['screen_secs']:.3f} s, confirm {st['confirm_secs']:.3f}"
              f" s), scalar host {st['host_secs']:.1f} s; K1 launches "
              f"{got_l['screen_fused']}, K2 launches "
              f"{got_l['weighted_cdf_sum']}; estimator-delta max="
              f"{deltas.max():.3e} mean={deltas.mean():.3e} over_ref_eps="
              f"{(deltas > compare_engines.EPS).sum()}/{len(deltas)}")
        check(n_bad == 0, f"compare_engines -c {crit}: {n_bad} mismatches")
        check(all(r[3] == "0.00e+00" for r in rows),
              f"compare_engines -c {crit}: a nonzero delta")
        # every pair of the prefix that phase 4 emitted at 0.9 is emitted
        # at 0.01; hll_a and baseline pass far more (the smh_a bands of
        # unrelated synthetic genomes never collide: its planted pairs)
        at_09 = {tuple(sorted(ln.split()[:2])) for ln in ref4[crit]}
        at_09 = {k for k in at_09 if k[0] in in_prefix and k[1] in in_prefix}
        print(f"    {len(at_09)} of phase 4's {len(ref4[crit])} pairs at "
              f"tau=0.9 lie in the prefix")
        check(at_09 <= {tuple(r[0].split("|")) for r in rows},
              f"compare_engines -c {crit}: a pair emitted at 0.9 is missing "
              "at 0.01")
        check(crit == "smh_a" or len(rows) > len(ref4[crit]),
              f"compare_engines -c {crit}: {len(rows)} pairs at tau=0.01, "
              f"not above phase 4's {len(ref4[crit])} at 0.9")
        check(got_l["screen_fused"] > 0, f"-c {crit} never launched K1")
        if crit == "hll_a":
            check(got_l["weighted_cdf_sum"] > 0, "-c hll_a never launched K2")
        launch_sum(launches, got_l)
    print(f"  10a differential took {time.perf_counter() - t10a:.1f} s")

    reset_launches(screen)
    st = {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-l", lst4, "-h", "0.01", "-c", "baseline",
                       "--device", str(dev)], stats=st)
    t_cli = time.perf_counter() - t0
    got_l = read_launches(screen)
    check(rc == 0, f"selection -c baseline -h 0.01 exit {rc}")
    got = buf.getvalue().splitlines()
    bank4 = mods["SketchBank"].from_sketch_files(names4)
    t0 = time.perf_counter()
    want = all_pairs_lines(hostref, fmt, bank4, criterion="baseline",
                           tau=0.01, apply_cb=False)
    t_ref = time.perf_counter() - t0
    n4 = len(names4)
    print(f"  [{card}] selection -c baseline -h 0.01 N={n4}: {len(got)} "
          f"lines in {t_cli:.2f} s; candidates {st['candidates']} of "
          f"{n4 * (n4 - 1) // 2} pairs, screen_secs {st['screen_secs']:.3f}"
          f", confirm_secs {st['confirm_secs']:.3f}, confirm pairs/s "
          f"{st['candidates'] / st['confirm_secs']:.6g} (plan "
          f"{st['plan_secs']:.3f} s, prune {st['prune_secs']:.3f} s, tiles "
          f"{st['tiles_live']}); K1 launches {got_l['screen_fused']}; host "
          f"reference (pooled oracle, all pairs) {len(want)} lines in "
          f"{t_ref:.1f} s")
    check(got == want, "selection -c baseline -h 0.01 differs from the "
          "host reference")
    check(len(got) > len(ref4["baseline"]), "baseline at 0.01 emitted no "
          "more than at 0.9")
    check(got_l["screen_fused"] > 0, "baseline -h 0.01 never launched K1")
    launch_sum(launches, got_l)
    reset_launches(screen)
    baseline_breakdown(torch, mods, bank4, 0.01, dev, card)
    launch_sum(launches, read_launches(screen))

    print("  10b: the timing sweep on phase 7's corpus", flush=True)
    files7 = [ln.strip() for ln in open(lst7) if ln.strip()]
    reset_launches(screen)
    t0 = time.perf_counter()
    host_rows = run_time_experiment.host_arm_rows(files7, 0.9, [64, 512], 1)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev_rows = run_time_experiment.device_arm_rows(lst7, 0.9, [64, 512],
                                                   [256, 512], 1, dev)
    t_dev = time.perf_counter() - t0
    got_l = read_launches(screen)
    csv_path = os.path.join(out_dir, "experimento_smh_comparativo.csv")
    run_time_experiment.write_csv(csv_path, host_rows + dev_rows)
    with open(csv_path) as fh:
        table = [ln.rstrip("\n") for ln in fh]
    print(f"  [{card}] run_time_experiment -l <{len(files7)} files> "
          f"--mh-sizes 64 512 --blocks 256 512 --reps 1: host arm "
          f"{t_host:.2f} s, cuda arm {t_dev:.2f} s; K1 launches "
          f"{got_l['screen_fused']}; {os.path.basename(csv_path)}:")
    for line in table:
        print("    " + line)
    kinds = ("smh_a", "CB+smh_a", "smh_a_kernel", "CB+smh_a_kernel")
    want_rows = sorted(
        [("host", "0", str(m), "1", c) for m in (64, 512)
         for c in ("build_smh", "smh_a", "CB+smh_a")]
        + [("cuda", str(b), str(m), "1", c) for b in (256, 512)
           for m in (64, 512) for c in ("build_smh",) + kinds])
    body = [ln.split(",") for ln in table[1:]]
    check(table[0] == ",".join(run_time_experiment.HEADER),
          f"timing CSV header {table[0]}")
    check(sorted(tuple(r[:5]) for r in body) == want_rows,
          "timing CSV rows are not the full set of both arms")
    check(all(float(r[5]) > 0.0 for r in body), "a nonpositive time")
    check(got_l["screen_fused"] > 0, "the timing sweep never launched K1")
    launch_sum(launches, got_l)
    # the device arm's build at m=512: the stage split of one build
    st = {}
    t0 = time.perf_counter()
    mods["build_bank_from_files"](files7, criterion="smh_a", aux_bytes=4096,
                                  device=dev, stats=st)
    print(f"  [{card}] build_bank_from_files -c smh_a -a 4096 (m=512) on "
          f"the device: {time.perf_counter() - t0:.2f} s; decode wait "
          f"{st['decode_secs']:.2f} s, pack {st['pack_secs']:.2f} s "
          f"({st['packs']} packs), chunked {st['chunked_secs']:.2f} s "
          f"({st['chunked_genomes']} genomes), fetch "
          f"{st['fetch_secs']:.3f} s, {st['smh_fallbacks']} SMH fallbacks")

    print(f"  10c: confirm throughput on the phase 5 bank, {L5_PAIRS} pairs",
          flush=True)
    rng = np.random.default_rng(10)
    ii, kk = confirm_throughput.random_pairs(bank.n, L5_PAIRS, rng)
    t0 = time.perf_counter()
    res, _, _ = confirm_throughput.confirm_rates(bank, ii, kk, dev, reps=1)
    print(f"  [{card}] confirm_throughput (tau=-100, every pair through "
          f"the full union-MLE; {time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(res)}")
    check(res["native_hist"], "the host rate was not the native one")
    lo, hi = confirm_throughput.reject_pairs(bank, picks, L5_PAIRS, rng)
    t0 = time.perf_counter()
    res, out = confirm_throughput.reject_rates(bank, lo, hi, dev, reps=1)
    print(f"  [{card}] confirm_throughput --reject (tau=0.9; "
          f"{time.perf_counter() - t0:.1f} s): {json.dumps(res)}")
    check(len(out) > 0 and res["reject_fraction"] > 0.5,
          "the reject workload emitted nothing or rejected too little")
    return launches


# Phase 11's sizes. 11a's differentials run the scalar host engine, whose
# wall grows as N^2 (validate_screened's host reference: 3.3 s at N=512,
# 20.7 s at the reference script's default 1024 on the H100 machine's
# host), so both run at an N that still holds every planted cluster (about
# 70 genomes) and keeps the whole script under 10 minutes; 11b's bank is
# the replication-scale one, never cut.
SCALE_SCREENED_N = 512
SCALE_HLLAUX_N = 256
SCALE_N = 131072  # 2 GiB of registers at p=14


def phase_scale(torch, mods, dev, card):
    """Phase 11: the at-scale validation harnesses
    (cuda_selection_criteria_tpu_torch/experiments). 11a validate_screened
    (smh_a, tau 0.8) and validate_hllaux (hll_a, hll_an: K2) on the card,
    each exactly equal to the scalar host reference; 11b the planted bench
    bank at N=131,072 through validate_131k_scale.run (stage walls, gate
    split, peak device memory) with phase 5's checks; 11c
    validate_ring_scale.run on the same bank object, on one strip (every
    visible card) and on two strips (two virtual devices of the card, so
    K1's strip entry runs at this scale), pairs equal to 11b's. Returns
    {kernel: launches} summed over the phase's runs, each read right after
    its own reset."""
    screen, v131, vring = (mods["screen"], mods["validate_131k_scale"],
                           mods["validate_ring_scale"])
    total = dict.fromkeys(LAUNCH_KEYS, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    print(f"  11a: validate_screened -n {SCALE_SCREENED_N} and "
          f"validate_hllaux -n {SCALE_HLLAUX_N} on the card", flush=True)
    for harness, argv in (
            (mods["validate_screened"], ["-n", str(SCALE_SCREENED_N)]),
            (mods["validate_hllaux"], ["-n", str(SCALE_HLLAUX_N)])):
        reset_launches(screen)
        t0 = time.perf_counter()
        rc = harness.main(argv + ["--device", str(dev)])
        launches = read_launches(screen)
        print(f"  [{card}] {harness.__name__.rsplit('.', 1)[-1]} "
              f"{' '.join(argv)}: exit {rc} in "
              f"{time.perf_counter() - t0:.1f} s; launches K1 "
              f"{launches['screen_fused']}, K2 "
              f"{launches['weighted_cdf_sum']}", flush=True)
        check(rc == 0, f"{harness.__name__} does not match the host "
              "reference")
        check(launches["screen_fused"] > 0, f"{harness.__name__} never "
              "launched K1")
        add(launches)
    check(total["weighted_cdf_sum"] > 0, "validate_hllaux never launched K2")

    print(f"  11b: validate_131k_scale.run, N={SCALE_N}", flush=True)
    bank, picks, bank_secs = v131.make_bank(SCALE_N)
    print(f"  planted bench bank N={SCALE_N} ({bank.regs.nbytes / 2**30:.2f} "
          f"GiB of registers) with {len(picks)} planted pairs made in "
          f"{bank_secs:.1f} s (host)", flush=True)
    params = mods["SelectionParams"](tau=0.9, criterion="smh_a")
    reset_launches(screen)
    record, pairs = v131.run(bank, params, ti=1024, device=dev)
    launches = read_launches(screen)
    record.update(v131.planted_check(pairs, len(picks)), bank_secs=bank_secs)
    print("  " + json.dumps(record), flush=True)
    print(f"  [{card}] screened N={SCALE_N}: total {record['total_secs']:.3f} "
          f"s (with the gate and screen warm-ups "
          f"{record['total_with_warmup_secs']:.3f} s), "
          f"{record['triangle_pairs_per_sec']:.6g} pairs/s over the full "
          f"triangle; launches K1 {launches['screen_fused']}, gate_counts "
          f"{launches['gate_counts']}; peak device "
          f"memory {record['peak_allocated_bytes'] / 2**30:.3f} GiB of "
          f"{record['device_total_bytes'] / 2**30:.1f} GiB; host peak "
          f"resident set {record['host_peak_rss_bytes'] / 2**30:.2f} GiB of "
          f"{record['host_total_bytes'] / 2**30:.1f} GiB")
    plan_room = record["device_bank_bytes"] + (1 << 29)
    print(f"  [{card}] screened N={SCALE_N}: upload "
          f"{record['upload_secs']:.3f} s, upload_stats "
          f"{json.dumps(record['upload_stats'])}; plan-stage peak "
          f"{record['plan_peak_allocated_bytes'] / 2**30:.3f} GiB beside "
          f"the padded bank's {record['device_bank_bytes'] / 2**30:.3f} GiB "
          f"(limit: the bank + 0.5 GiB); whole-run peak "
          f"{record['peak_allocated_bytes'] / 2**30:.3f} GiB (6.005 GiB "
          "with the whole-bank upload it replaced, NVIDIA H100 80GB HBM3, "
          "700 W)")
    check(record["plan_peak_allocated_bytes"] <= plan_room,
          "validate_131k_scale: the plan stage held more than the padded "
          "bank + 0.5 GiB on the card")
    check(record["planted_recovered"], "validate_131k_scale: planted pairs "
          "not recovered")
    check(launches["screen_fused"] > 0, "validate_131k_scale never launched "
          "K1")
    check(launches["gate_counts"] > 0, "validate_131k_scale never launched "
          "the gate-count kernel")
    mods["verify_pairs"](bank, [(i, i + 1) for i in picks], pairs, "smh_a")
    add(launches)

    print("  11c: validate_ring_scale.run on the same bank", flush=True)
    for label, mesh in (
            ("one strip (every visible card)", None),
            ("two strips (two virtual devices of the card)",
             mods["mesh"].row_mesh(["cuda:0"] * 2))):
        reset_launches(screen)
        rrec, rpairs = vring.run(bank, params, mesh=mesh, device=dev)
        launches = read_launches(screen)
        rrec.update(v131.planted_check(rpairs, len(picks)))
        print("  " + json.dumps(rrec), flush=True)
        print(f"  [{card}] ring N={SCALE_N}, {label}: total "
              f"{rrec['total_secs']:.3f} s (upload {rrec['upload_secs']:.3f} "
              f"s, upload_stats {json.dumps(rrec['upload_stats'])}), "
              f"{len(rpairs)} pairs; launches K1 "
              f"{launches['screen_fused']} (strips {launches['strips']}), "
              f"gate_counts {launches['gate_counts']}; peak device memory "
              f"{rrec['peak_allocated_bytes'] / 2**30:.3f} GiB")
        check(rpairs == pairs, f"ring N={SCALE_N} ({label}) != the screened "
              "harness's pairs")
        check(launches["screen_fused"] > 0, f"ring N={SCALE_N} ({label}) "
              "never launched K1")
        check(launches["gate_counts"] > 0, f"ring N={SCALE_N} ({label}) "
              "never launched the gate-count kernel")
        add(launches)
    check(total["strips"] > 0, "phase 11 never launched K1's strip entry")
    return total


# Phase 12's sizes: the bench's headline bank (bench.py's N_GENOMES),
# scale_sweep's smallest default size (its next, 8192, is left out to keep
# the script under 10 minutes on a slow host) and three kernel_tuning
# configurations of K2 (ti:r_sub:precision[:chunkK]).
BENCH_N = 16384
SWEEP_SIZES = (4096,)
TUNING_CONFIGS = ("1024:auto:int8:chunk64,1024:auto:int8:chunk16,"
                  "512:auto:int8")


def k2_p14_config(torch, screen, setup, card):
    """K2 at the bench's raw width, p=14 and ti = tj = 1024, on the first
    span of the sorted bench triangle (64 tiles, the raw sweep's first
    launch): bit-equal to its plain version over every tile, timed beside
    it, its bound (k2_bound) and torch._int_mm over the same CDFs."""
    rows, cols = setup.span_tiles[setup.spans[0]]
    args = [setup.d_regs, rows, cols]
    kw = dict(p=14, values=setup.values, ti=1024, tj=1024)
    nbins = len(setup.values) - 1
    err = k2_vs_plain(torch, screen, args, kw)
    print(f"  K2 p=14 ti=tj=1024 tiles={len(rows)} bins={nbins}: "
          f"max_abs_err={err}")
    check(err == 0, "K2 p=14 ti=tj=1024 kernel != plain")
    plain_ms = cuda_ms(torch, lambda: screen._screen_s_z_plain(
        *args, **kw), 1)
    ms = cuda_ms(torch, lambda: screen.screen_s_z(*args, **kw), 10)
    bound_ms, bound_by = k2_bound(torch, rows, cols, setup.values, 14, 1024)
    library_ms = int_mm_ms(torch, setup.d_regs, rows, cols, setup.values,
                           1024, 1024)
    ms2 = cuda_ms(torch, lambda: screen.screen_s_z(*args, **kw), 10)
    print(f"  [{card}] K2 p=14: {ms:.3f} / {ms2:.3f} ms (two turns) vs plain "
          f"{plain_ms:.3f} ms per launch of {len(rows)} tiles; bound "
          f"{bound_ms:.3f} ms ({bound_by}), share of the bound "
          f"{bound_ms / ms:.3f}; library (torch._int_mm, {nbins} x "
          f"{len(rows)} calls) {library_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_bench(torch, mods, dev, card):
    """Phase 12: the bench protocol (cuda_selection_criteria_tpu_torch/
    experiments/bench.py, scale_sweep.py, kernel_tuning.py) on the card:
    the measured copy bandwidth and the baseline; bench.record at N=16384,
    ti=1024 (headline, raw, tc_util) with its launches counted, the
    headline sweep's per-tile counts equal to K1's plain version's; K2 at
    p=14, ti = tj = 1024 against its plain version (k2_p14_config); three
    kernel_tuning configurations and scale_sweep at 4096. Returns
    ({kernel: launches} of the bench's measure, K2's p=14 record)."""
    screen, synth, hopper = mods["screen"], mods["synth"], mods["hopper"]
    from cuda_selection_criteria_tpu_torch.experiments import (
        bench, kernel_tuning, scale_sweep)

    hbm = hopper.measured_hbm_bytes_per_s(dev)
    baseline = hopper.card_baseline(dev)
    print(f"  [{card}] device-to-device copy of 2 GiB: {hbm:.6g} bytes/s "
          f"(read + write; published {rates()[1]:.3g}); baseline "
          f"{baseline:.6g} pairs/s (2 x 16 KiB a pair; bench.py's sm_86 "
          "2.32e7)", flush=True)
    check(0 < hbm <= rates()[1], "the measured copy bandwidth is not below "
          "the published rate")
    t0 = time.perf_counter()
    bank = synth.bench_bank(BENCH_N)
    print(f"  bench bank N={BENCH_N} made in {time.perf_counter() - t0:.1f} s "
          "(host)", flush=True)
    reset_launches(screen)
    rec = bench.record(BENCH_N, 3, 1024, dev, bank=bank)
    launches = read_launches(screen)
    print("  " + json.dumps(rec), flush=True)
    sweep_ms = (BENCH_N * (BENCH_N - 1) // 2) / rec["value"] * 1e3
    print(f"  [{card}] bench N={BENCH_N}: headline {rec['value']:.6g} pairs/s"
          f" ({sweep_ms:.3f} ms a sweep; vs_baseline "
          f"{rec['vs_baseline']:.4g}), raw (K2) "
          f"{rec['raw_kernel_pairs_per_sec']:.6g} pairs/s (raw_vs_baseline "
          f"{rec['raw_vs_baseline']:.4g}), tc_util {rec['tc_util']:.4f}; "
          f"launches K1 {launches['screen_fused']}, K2 "
          f"{launches['weighted_cdf_sum']}", flush=True)
    check(launches["screen_fused"] > 0 and launches["weighted_cdf_sum"] > 0,
          "the bench never launched K1 and K2")
    check(rec["value"] > 0 and rec["raw_kernel_pairs_per_sec"] > 0
          and rec["card"] == hopper.card_line(), "malformed bench record")

    setup = bench.setup(BENCH_N, ti=1024, device=dev, bank=bank)
    counts, _ = bench.headline_collect(bench.headline_dispatch(setup))
    want = torch.cat([screen._screen_hits_fused_plain(
        setup.d_regs, *setup.span_tiles[span], setup.d_e, setup.d_fp,
        setup.n, setup.tau_scr, setup.tau_cb, 14, setup.values, 1024,
        setup.n_bands, True, True)[1] for span in setup.spans])
    check(np.array_equal(counts, want.cpu().numpy()), "the bench's headline "
          "counts differ from K1's plain version's")
    print(f"  headline sweep: {len(counts)} tiles, {int(counts.sum())} hits, "
          "per-tile counts equal to K1's plain version's")
    k2 = k2_p14_config(torch, screen, setup, card)
    del setup

    for row in kernel_tuning.rows(TUNING_CONFIGS, BENCH_N, device=dev,
                                  bank=bank):
        print(f"  [{card}] kernel_tuning " + json.dumps(row), flush=True)
        check("error" not in row, f"kernel_tuning {row['config']} failed")
    for row in scale_sweep.rows(SWEEP_SIZES, device=dev):
        print(f"  [{card}] scale_sweep " + json.dumps(row), flush=True)
        check(row["pairs_per_sec"] > 0, "scale_sweep row without a rate")
    return launches, k2


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
    from cuda_selection_criteria_tpu_torch.native import fastx
    from cuda_selection_criteria_tpu_torch.ops import (_build, criteria,
                                                      estimators, pairwise,
                                                      screen)
    from cuda_selection_criteria_tpu_torch.parallel import (
        distributed, mesh, ring, scheduler, screened)
    from cuda_selection_criteria_tpu_torch.parallel.selection import (
        SelectionParams, format_results, select_pairs)
    from cuda_selection_criteria_tpu_torch.utils import (formats, hopper,
                                                        hostref, synth)

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
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(fastx.info)  # g++ builds while nvcc does
        for name, (path, build_secs, log) in _build.build().items():
            print(log.strip())
            print(f"built {os.path.relpath(path, HERE)} in {build_secs:.2f} s")
            spills = [ln for ln in log.splitlines() if "spill" in ln and
                      "0 bytes spill stores, 0 bytes spill loads" not in ln]
            check(not spills, f"{name}: ptxas spills registers: {spills}")
            check("serialized" not in log,
                  f"{name}: ptxas serializes the wgmma (see the log above)")
            _build.library(name)
        info = host_lib.result()
    print(info["log"].strip())
    check(info["error"] is None, f"libfastx did not build: {info['error']}")
    gxx = subprocess.run([_build.GXX, "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(f"built {os.path.relpath(info['path'], HERE)} in "
          f"{info['build_secs']:.2f} s with {gxx.splitlines()[0]}; zlib "
          f"{info['zlib']}")

    print("== phase 3: kernel vs plain", flush=True)
    max_err = max(phase_kernel_p8(torch, screen, screened, dev),
                  phase_kernel_edges(torch, screen, screened, dev),
                  phase_kernel_strips(torch, screen, screened, dev))
    t0 = time.perf_counter()
    rng = np.random.default_rng(0xBE7C)
    bank, picks = bench_bank(models, synth, 16384, rng, 300)
    hbank, hpicks = hll_bench_bank(models, synth, 16384,
                                   np.random.default_rng(0x4A11), 300)
    print(f"  bench banks N=16384 p=14 (m=32 SMH; p_aux=8 HLL) with "
          f"{len(picks)} and {len(hpicks)} planted pairs made in "
          f"{time.perf_counter() - t0:.1f} s (host)")
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
    hparams = SelectionParams(tau=0.9, criterion="hll_a")
    hplan = screened.ScreenPlan(hbank, hparams, 1024, device=dev)
    hr, hc = scheduler.triangle_block_ids(hplan.e_s, hplan.tau, 1024,
                                          use_cb_skip=False)
    hr64 = torch.from_numpy(hr[:chunk].astype(np.int32)).to(dev)
    hc64 = torch.from_numpy(hc[:chunk].astype(np.int32)).to(dev)
    # dense: the hll primary call of _screen_chunk_hllaux (CB, no bands);
    # gated: the smh_a call (CB and LSH bands)
    k1 = {"dense": k1_config(
        torch, screen, "dense (hll_a primary)",
        [hplan.d_regs, hr64, hc64, hplan.d_e, hplan.d_fp],
        dict(n_real=hplan.n, tau_scr=hplan.tau_scr, tau_cb=hplan.tau_cb,
             p=14, values=hplan.values, ti=1024, n_bands=1, use_cb=True,
             use_smh=False), card)}
    k1["gated"] = k1_config(torch, screen, "gated (smh_a)", args, kw, card)
    k1["strips"] = k1_strips_config(torch, screen, hplan, card)
    max_err = max(max_err, k1["dense"]["max_abs_err"],
                  k1["gated"]["max_abs_err"], k1["strips"]["max_abs_err"])

    k2_err = max(phase_k2_small(torch, screen, dev),
                 phase_k2_edges(torch, screen, dev))
    k2_args = [hplan.d_aux_regs, hr64, hc64]
    k2_kw = dict(p=8, values=hplan.values_aux, ti=1024, tj=1024)
    err = k2_vs_plain(torch, screen, k2_args, k2_kw)
    k2_bins = len(hplan.values_aux) - 1
    print(f"  K2 p_aux=8 ti=1024 tiles={chunk} bins={k2_bins}: "
          f"max_abs_err={err}")
    check(err == 0, "K2 p_aux=8 ti=1024 kernel != plain")
    k2_err = max(k2_err, err)
    k2_plain_ms = cuda_ms(torch, lambda: screen._screen_s_z_plain(
        *k2_args, **k2_kw), 2)
    k2_ms = cuda_ms(torch, lambda: screen.screen_s_z(*k2_args, **k2_kw), 10)
    k2_bound_ms, k2_bound_by = k2_bound(torch, hr64, hc64, hplan.values_aux,
                                        8, 1024)
    k2_library_ms = int_mm_ms(torch, hplan.d_aux_regs, hr64, hc64,
                              hplan.values_aux, 1024, 1024)
    k2_ms2 = cuda_ms(torch, lambda: screen.screen_s_z(*k2_args, **k2_kw), 10)
    hll_chunk_ms = cuda_ms(torch, lambda: hplan.screen_chunk(
        hr[:chunk], hc[:chunk]), 3)
    print(f"  [{card}] K2 {k2_ms:.3f} / {k2_ms2:.3f} ms (two turns) vs plain "
          f"{k2_plain_ms:.3f} ms per "
          f"launch of {chunk} tiles at p_aux=8; bound {k2_bound_ms:.3f} ms "
          f"({k2_bound_by}), share of the bound {k2_bound_ms / k2_ms:.3f}; "
          f"library (torch._int_mm, {k2_bins} x {chunk} calls) "
          f"{k2_library_ms:.3f} ms; hll screen chunk (K1 + K2 + aux "
          f"compare) {hll_chunk_ms:.3f} ms")

    gate = phase_gate(torch, screen, screened, scheduler, criteria, dev,
                      card)

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
    # the files and the host reference lines stay for phase 8
    tmp4 = tempfile.TemporaryDirectory()
    tmp = tmp4.name
    ref4 = {}
    names = [os.path.join(tmp, f"g{i:04d}.fna.gz") for i in range(n4)]
    for name, r, a, h in zip(names, regs4, aux4, hll4):
        formats.write_hll(name + ".hll", 14, r)
        formats.write_smh(name + ".smh32", a)
        formats.write_hll(name + ".hll_8", 8, h)
    lst = os.path.join(tmp, "list.txt")
    with open(lst, "w") as fh:
        fh.write("\n".join(names) + "\n")
    t0 = time.perf_counter()
    loaded = [fastx.read_hll_batch([f + ".hll" for f in names], 14, 8),
              fastx.read_hll_batch([f + ".hll_8" for f in names], 8, 8),
              fastx.read_smh_batch([f + ".smh32" for f in names], 32, 8)]
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    read = [np.stack([formats.read_hll(f + ".hll")[1] for f in names]),
            np.stack([formats.read_hll(f + ".hll_8")[1] for f in names]),
            np.stack([formats.read_smh(f + ".smh32") for f in names])]
    t_numpy = time.perf_counter() - t0
    err = max(max_abs_diff(a, b) for a, b in zip(loaded, read))
    print(f"  [{card}] load {n4} x (.hll, .hll_8, .smh32): native batch "
          f"readers on 8 threads {t_native:.3f} s, numpy readers "
          f"{t_numpy:.3f} s ({t_numpy / t_native:.2f}x); max_abs_err={err}")
    check(err == 0, "native loaders differ from the numpy readers")
    ii, kk = np.random.default_rng(4).integers(0, n4, size=(2, 1 << 16))
    hists = {}
    for how, fn in (("native, 8 threads", hostref.pair_union_histograms),
                    ("native, 1 thread", lambda *a: fastx.
                     pair_union_hist(*a, threads=1)),
                    ("numpy", hostref.pair_union_histograms_np)):
        t0 = time.perf_counter()
        hists[how] = fn(read[0], ii, kk)
        secs = time.perf_counter() - t0
        print(f"  [{card}] union histograms of {len(ii)} pairs at p=14, "
              f"{how}: {secs:.3f} s = {len(ii) / secs:.5g} pairs/s")
    check(all(np.array_equal(h, hists["numpy"]) for h in hists.values()),
          "native union histograms differ from numpy's")
    check(hostref.hist_backend() == "native", "the oracle's histograms are "
          "not the native ones")
    # the bank's cardinalities take their row histograms from the native
    # pass: the numpy loop must never be the card machine's route
    check(fastx.available(), "libfastx is not available: host_cards would "
          "count the row histograms with numpy")
    rows = {}
    for how, fn in (("native row_hist, 8 threads", fastx.row_hist),
                    ("numpy (_row_hists_numpy)",
                     models.bank._row_hists_numpy)):
        t0 = time.perf_counter()
        rows[how] = fn(read[0])
        secs = time.perf_counter() - t0
        print(f"  [{card}] row histograms of the {n4} x 2^14 bank, {how}: "
              f"{secs:.4f} s")
    check(all(np.array_equal(h, rows["numpy (_row_hists_numpy)"])
              for h in rows.values()),
          "native row histograms differ from numpy's")
    for crit in ("smh_a", "cb", "baseline", "hll_a", "hll_an"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-l", lst, "-a", "256", "-h", "0.9", "-c",
                           crit, "--device", str(dev)])
        t_cli = time.perf_counter() - t0
        check(rc == 0, f"cli exit {rc}")
        got = buf.getvalue().splitlines()
        t0 = time.perf_counter()
        fbank = models.SketchBank.from_sketch_files(
            names, criterion=None if crit in ("cb", "baseline") else crit)
        if crit == "baseline":
            want = all_pairs_lines(hostref, format_results, fbank,
                                   criterion="baseline", tau=0.9,
                                   apply_cb=False)
            how = ("PairOracle.confirm_pairs over all pairs, 8 threads, "
                   f"{hostref.hist_backend()} union histograms")
        else:
            want = format_results(hostref.select_pairs_host(
                fbank, 0.9, crit))
            how = "select_pairs_host"
        print(f"  [{card}] -c {crit}: {len(got)} lines in {t_cli:.2f} s;"
              f" host reference ({how}) {len(want)} lines in "
              f"{time.perf_counter() - t0:.1f} s")
        check(got == want, f"cli -c {crit} differs from host reference")
        check(len(got) >= 32, f"cli -c {crit} found too few pairs")
        ref4[crit] = want

    print("== phase 5: main path, select_pairs smh_a N=16384 p=14",
          flush=True)
    t0 = time.perf_counter()
    cards = models.bank.host_cards(bank.regs, 14)
    t_cards = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = hostref.ertl_mle_batch(models.bank._row_hists_numpy(bank.regs), 14)
    t_plain = time.perf_counter() - t0
    print(f"  [{card}] host_cards N={bank.n} p=14 (native row histograms, "
          f"MLE in one call): {t_cards:.4f} s; numpy row histograms and "
          f"the same MLE: {t_plain:.4f} s; cards bit-equal")
    check(np.array_equal(cards.view(np.int64), want.view(np.int64)),
          "host_cards differs from the MLE of the numpy row histograms")
    out, launches = run_main_path(torch, screen, select_pairs, bank, params,
                                  dev, card)
    check(launches["screen_fused"] > 0, "main path never launched K1")
    check(launches["gate_counts"] > 0, "main path never launched the "
          "gate-count kernel")
    verify_pairs(hostref, bank, [(i, i + 1) for i in picks], out, "smh_a")
    screened_out = {"smh_a": out}  # phase 9 holds the other engines to it
    device_profile(torch, lambda: select_pairs(bank, params, device=dev),
                   card, "warm select_pairs -c smh_a")

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
        check(hl["screen_fused"] > 0 and hl["weighted_cdf_sum"] > 0
              and hl["gate_counts"] > 0,
              f"-c {crit} never launched K1, K2 and the gate-count kernel")
        verify_pairs(hostref, hbank, [(i, i + 1) for i in hpicks], out,
                     crit)
        screened_out[crit] = out
        for name in launches:
            launches[name] += hl[name]
    device_profile(torch, lambda: select_pairs(hbank, hparams, device=dev),
                   card, "warm select_pairs -c hll_a")

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

    print("== phase 7: FASTA -> build_sketch -> selection, time_smh",
          flush=True)
    t7 = time.perf_counter()
    # the corpus stays for phase 10b
    tmp7 = tempfile.TemporaryDirectory()
    fl, build_err, lst7 = phase_fasta(torch, dev, card, {"seed": 0xFA57A},
                                      tmp7.name)
    for name in launches:
        launches[name] += fl[name]
    print(f"  phase 7 took {time.perf_counter() - t7:.1f} s")

    print("== phase 8: dense exact engine", flush=True)
    t8 = time.perf_counter()
    phase_dense_cli(models, cli, hostref, format_results, names, lst, ref4,
                    dev, card)
    mods = dict(screen=screen, pairwise=pairwise, estimators=estimators,
                hostref=hostref, select_pairs=select_pairs,
                SelectionParams=SelectionParams)
    phase_dense_main(torch, mods, bank, picks, "smh_a", dev, card)
    phase_dense_main(torch, mods, hbank, hpicks, "hll_a", dev, card)
    phase_dense_mle(torch, estimators, hostref, [bank.regs, regs4], dev,
                    card)
    phase_checkpoint(torch, screen, screened, bank, params, dev, card)
    print(f"  phase 8 took {time.perf_counter() - t8:.1f} s")

    print("== phase 9: multi-device engines, four virtual devices of one card",
          flush=True)
    t9 = time.perf_counter()
    mods.update(ring=ring, screened=screened, mesh=mesh, cli=cli,
                distributed=distributed,
                verify_pairs=lambda *a: verify_pairs(hostref, *a),
                bench_bank=lambda n, rng, k: bench_bank(models, synth, n, rng,
                                                        k))
    md = phase_multi_device(torch, mods, {"smh_a": (bank, picks),
                                          "hll_a": (hbank, hpicks)},
                            screened_out, lst, ref4, dev, card)
    print(f"  phase 9 took {time.perf_counter() - t9:.1f} s")

    print("== phase 10: the reference's experiment protocols (L5)",
          flush=True)
    t10 = time.perf_counter()
    mods.update(format_results=format_results, SketchBank=models.SketchBank,
                build_bank_from_files=models.bank.build_bank_from_files)
    l5 = phase_l5(torch, mods, names, lst, ref4, lst7, bank, picks, dev,
                  card)
    tmp4.cleanup()
    tmp7.cleanup()
    print(f"  phase 10 took {time.perf_counter() - t10:.1f} s")

    print("== phase 11: the at-scale validation harnesses, N=131072",
          flush=True)
    t11 = time.perf_counter()
    from cuda_selection_criteria_tpu_torch.experiments import (
        validate_131k_scale, validate_hllaux, validate_ring_scale,
        validate_screened)
    mods.update(validate_131k_scale=validate_131k_scale,
                validate_ring_scale=validate_ring_scale,
                validate_screened=validate_screened,
                validate_hllaux=validate_hllaux)
    scale = phase_scale(torch, mods, dev, card)
    print(f"  phase 11 took {time.perf_counter() - t11:.1f} s")

    print("== phase 12: the bench protocol (bench, kernel_tuning, "
          "scale_sweep)", flush=True)
    t12 = time.perf_counter()
    mods.update(synth=synth, hopper=hopper)
    bench_launches, k2_p14 = phase_bench(torch, mods, dev, card)
    print(f"  phase 12 took {time.perf_counter() - t12:.1f} s")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    # K1's headline numbers are the dense launch's; the gated launch's and
    # the strip variant's (with its launches in the phase 9 ring runs) ride
    # beside them; K2's are the p_aux=8 launch's, its p=14 launch (phase
    # 12) beside them. `launches` counts the main paths of phases 5 to 7;
    # the phase 9 engines', phase 10's, phase 11's and phase 12's bench
    # launches stand in their own records.
    measured = {
        "screen_fused": dict(
            {key: k1["dense"][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}, max_abs_err=max_err, gated=k1["gated"],
            strips=dict(k1["strips"], launches=md["ring"]["strips"],
                        scale=dict(launches=scale["strips"])),
            ring=dict(launches=md["ring"]["screen_fused"]),
            sharded=dict(launches=md["sharded"]["screen_fused"]),
            l5=dict(launches=l5["screen_fused"]),
            scale=dict(launches=scale["screen_fused"]),
            bench=dict(launches=bench_launches["screen_fused"])),
        "weighted_cdf_sum": dict(
            max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
            bound_ms=k2_bound_ms, bound_by=k2_bound_by,
            library_ms=k2_library_ms,
            ring=dict(launches=md["ring"]["weighted_cdf_sum"]),
            sharded=dict(launches=md["sharded"]["weighted_cdf_sum"]),
            l5=dict(launches=l5["weighted_cdf_sum"]),
            scale=dict(launches=scale["weighted_cdf_sum"]),
            p14=k2_p14,
            bench=dict(launches=bench_launches["weighted_cdf_sum"])),
        "gate_counts": dict(
            gate, ring=dict(launches=md["ring"]["gate_counts"]),
            sharded=dict(launches=md["sharded"]["gate_counts"]),
            l5=dict(launches=l5["gate_counts"]),
            scale=dict(launches=scale["gate_counts"]),
            bench=dict(launches=bench_launches["gate_counts"]))}
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", route_detail=detail, source=src,
        replaces=replaces, launches=launches[name], **measured[name])
        for name, (src, replaces, detail) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
