#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA card: builds the CUDA
kernels from this checkout, holds each against its plain PyTorch version,
runs the selection CLI end to end and drives the main paths at the
reference bench's bank size.

    python3 chip_smoke.py            # needs one CUDA card; under 10 minutes

Phases (any failure exits non-zero, without the final result line):
  1. device   - card name and power limit, torch / CUDA / nvcc versions
  2. build    - nvcc builds every csrc/*.cu for sm_90a, all at once, and
                experiments/reference_kernel.cu (the reference's own
                kernel_CBsmh, a measured baseline) meanwhile; the
                ptxas log must show no spill (the MLE and row-histogram
                kernels' registers and shared memory printed) and no
                serialized wgmma;
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
                column bank; each timed K1 launch with the plane scratch
                of its own blocks (a shared list, or one a strip), its
                pack stage's ms from a profiler trace beside its bound
                and its scratch bytes a launch. K2 vs its plain version,
                bit-equal S and Z: p_aux = 5, 6, 8 (ti=64, tj=64 and
                128, a separate column bank, with and without zeros, a
                truncated value list); p = 5, 7, 8, 9, 10, 14 with 1, 2, 3, 5 and 13 bins
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
                256-tile chunks and its bound. The presence kernel
                (bank_values, the aux bank's present values) vs its plain
                version on 16 MiB + 13 uniform bytes 0-255, from an aligned
                start and from byte 1. The row-histogram kernel (the plan's
                row_hist: every row's register histogram and the present
                values in one pass) vs its plain version and numpy's row
                bincounts, bit-equal histograms and values: rows of 100 and
                48 registers (not 16 bytes a lane), rows that start
                unaligned, row counts that are not a multiple of the CTA's
                4 rows, all-zero rows, values up to 64 - p + 1, dense rows
                of real-sized genomes at p=14, rows of one value each
                (0..63), one row of 2^31 - 1 bytes (the largest R), a row
                of 2^31 refused before any launch and a byte of 64 that
                both versions refuse; then the N=16384 bench bank as the phase
                3 plan uploaded it (its cards from the card's histograms
                bit-equal to host_cards), timed beside its plain version,
                its bound and one torch.bincount of row * 64 + reg. The
                ERTL-MLE kernel (estimators.ertl_mle: the plan's cards, the
                dense engines' union MLE) vs its plain version, bit-equal
                estimates and log1p flags in f64 and f32 on int32, int64
                and float32 histograms at p=8 and 14 (pair unions, rows on
                the log1p branch, empty, saturated and one-bin rows, 1306
                rows: not a multiple of its 128-row CTA), its f64 estimates
                0 ulp from hostref.ertl_mle_batch off the log1p branch,
                cards_from_hists bit-equal to the host MLE with its host
                rows; then the wrapper timed in two turns beside its
                plain version and its bound (experiments/mle_split.
                work_bound) on the 16k bank's histograms, on 524,288 rows
                (those histograms 32 times), on 524,288 rows of
                real-sized genomes (synth.genome_hists) and on one dense
                tile's 512 x 512 unions at p=14 (f32 and f64) and
                p_aux=8 (the launch alone and the ablation's variants:
                experiments/mle_split.py). The
                band-fingerprint kernel (band_fingerprints: the smh plan's
                d_fp from its unsorted aux bank through its row map) vs its
                plain version and band_fingerprints_np of the host-sorted,
                zero-padded aux, bit-equal: m = 8, 32, 64, 256 at the
                splits of tau 0.5, 0.8, 0.9 and (1, m), words with the top
                bit set and all-ones words, padded positions on the zero
                row, a bank 8 bytes off a 16-byte boundary; then at
                smh_a-524k's 524,288 rows of m = 32, timed (the launch
                alone and the wrapper) beside its plain version and its
                bound. The unpack kernel of the packed bank upload
                (regpack.unpack_rows) vs its plain version, bit-equal and
                equal to the host rows: k = 1..7 on the word path and on
                the byte path (rows of 1, 17 and 2049 bytes a plane, and
                banks 8 bytes off a 16-byte boundary), a grid stride that
                is not a multiple of a row's words, odd row counts, i0 >
                0, alphabets without 0; then on a 128 MiB slab (8192 rows
                of the bench bank, and a k = 6 slab) timed on both paths
                beside its plain version and its
                bound; library none. K1's
                cases above include banks read through a shuffled row map
                (the plan's layout: its own row order and a zero row), and
                the bench launches read the plan's bank through its map
  4. cli      - planted .hll/.smh32/.hll_8 files for N=2048 genomes, read
                by the native threaded loaders and the numpy readers
                (bit-equal, both walls); the native fused union
                histograms against the numpy ones on 2^16 pairs; the
                run fails unless libfastx is available; the native row
                histograms (fastx.row_hist, the cards' pass) against
                the numpy ones on the p=14 bank, bit-equal, both walls; the
                selection CLI's lines for smh_a, cb, baseline, hll_a and
                hll_an must equal the exact host reference's (its wall,
                on the native histograms); selection -c smh_a once more in
                a fresh interpreter, its lines equal and its main having
                called utils/hostmem.enable_arena_reuse
  5. main     - host_cards on the N=16384 bank (its wall) bit-equal to
                the MLE of the numpy row histograms (their wall) and to
                the cards the phase 3 plan set from the card's histograms
                and the MLE kernel;
                select_pairs(smh_a, tau=0.9) on N=16384 genomes at p=14
                (256 MiB of registers on the card) with planted
                near-duplicates: every planted pair the exact oracle passes
                is emitted, every emitted pair is oracle-confirmed with the
                identical Jaccard, and K1, the gate-count kernel, the
                row-histogram kernel, the MLE kernel and the
                band-fingerprint kernel were launched (fp_secs printed);
                the phase 3 plan's d_fp bit-equal to band_fingerprints_np
                of its host-sorted, zero-padded aux; stage walls, a
                profiler trace of one warm run and the screen's pairs/s
                over the full triangle; then the packed upload's path,
                select_pairs_screened(upload_pack=True) on the same bank
                without cards, lines equal to the raw route's, the unpack
                kernel, the row histograms, the MLE, the fingerprints, the
                gate prune and K1 launched, and both routes' upload split
                in turns (raw, packed, packed, raw)
  6. hll      - select_pairs(hll_a) and (hll_an), tau=0.9, on N=16384
                genomes at p=14 with aux HLLs at p_aux=8 from the same
                hashes, planted near-duplicates: the checks of phase 5, K1,
                K2, the row-histogram kernel and the presence kernel (the
                aux bank) launched; stage walls, peak device memory, a
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
  8. dense    - the dense exact engine (indicator products as torch
                ops, the ERTL-MLE through its kernel on every tile): the
                selection CLI with --engine dense on phase 4's files for
                smh_a (--precision bf16 and int8), smh_only, cb, baseline,
                hll_a and hll_an equal to the host reference and the
                screened engine's lines; select_pairs(engine="dense") on
                the phase 5 and 6 banks (smh_a, hll_a) with the checks of
                phase 5, its wall and per-tile split (products, MLE)
                beside the screened engine's wall; the card's f64 MLE in
                ulp from hostref.ertl_mle_batch (0 on pair unions) and the
                f32 MLE's relative error; a checkpointed screened sweep cut to two records
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
                bank with 2^18 pairs: host and device-assisted at
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
                checks, then a plan on that bank whose d_fp is held as in
                phase 5, and the packed plan (upload_pack=True) on the
                same bank: its d_bank equal to the raw plan's, its
                plan-stage peak, taken on its own, within the bank + 0.5
                GiB, the unpack kernel launched, both routes' upload
                split in turns (raw, packed | packed, raw); before it,
                the presence kernel and the row-histogram kernel on that
                bank's 2 GiB against their plain versions, timed beside
                them and their bounds, the
                presence kernel beside one torch.bincount of its uint8
                bytes (the row histograms' bincount of row * 64 + reg
                would take a 16 GiB int64 index, not timed; the
                ablation's variants: experiments/hist_split.py);
                validate_ring_scale.run
                on the same bank on one strip and on two strips of the
                card (K1's strip entry), pairs equal
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
                scale_sweep at N=4096; then the reference's own kernel
                (experiments/reference_kernel.py): at N=2048 on phase 4's
                bank the same lines and bit-equal sims as its plain
                version with the aux as drawn, with every aux row equal
                (every pair through hll_union_card) and on a prefix of
                1,000,003 pairs at tau -1, the union launch timed beside
                the plain version and its bound; on the N=16384 bench bank
                ref_gated_pairs_per_sec (the whole triangle, the gate
                first), ref_union_pairs_per_sec (a prefix of at least 1 s
                a launch, every aux row equal), card_baseline and the
                share; its own record in the kernels line
 14. cli      - the selection CLI from sketch files with a real
                cardinality spread (experiments/validate_cli_scale.py at
                N=16384, --sub 4096): 16,384 real-sized genomes (2^20 to
                2^24 hashes, log-uniform, so CB prunes) with 256 planted
                pairs of J 0.80-1.00, written as .hll / .smh32 files;
                `python -m ...cli.selection -l <list> -t 8 -a 256 -h 0.9
                -c smh_a` in a fresh interpreter; the load by the native
                readers, byte-equal to the draw; cli.main in this process
                (its K1, gate, row-histogram, MLE and fingerprint launches
                counted); every printed line, every planted pair and
                100,000 random pairs held to the exact host cascade; the
                CLI on a 4096-genome sub-collection equal to
                select_pairs_host; no module of JAX loaded

main calls utils/hostmem.enable_arena_reuse() before it imports torch
(as the CLIs do); before the card's name and power limit it prints that
call's result with the host's glibc version, THP mode and cores.

The last two lines are a JSON record of the kernels (launches on the main
paths of phases 5 to 7 and 14, the packed path of phase 5 among them,
times, bounds, library times, K2's p=14 record, the MLE's other shapes,
phase 14's launches in records of their own too, and
the launches of phase 8's dense engine (the MLE), of phase 9's ring and
tile-sharded runs, of phase 10, of phase 11 and of phase 12's bench in
records of their own; the reference kernel's record last, with the
launches of phase 12's rates run) and the result line
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
    # not a Pallas kernel: the JAX bank_values' one pass is the native host
    # scan fastx_value_presence (cuda_selection_criteria_tpu/native/
    # fastx.cpp:461)
    "value_presence": (f"{PKG}/csrc/value_presence.cu",
                       "cuda_selection_criteria_tpu/ops/screen.py:185",
                       "bank_values (native fastx_value_presence): one "
                       "pass of 16-byte loads, a 64-bit register mask a "
                       "thread for values below 64, shared atomicOr for "
                       "the rest, one global atomicOr a block and word"),
    # not a Pallas kernel: the histogram half of SketchBank.compute_cards (a
    # host np.bincount; estimators.hll_histogram on the CPU backend)
    "row_hist": (f"{PKG}/csrc/row_hist.cu",
                 "cuda_selection_criteria_tpu/models/bank.py:97",
                 "SketchBank.compute_cards' bincount of row * 64 + reg: one "
                 "warp a row, 16-byte loads two batches in flight, each "
                 "byte one __byte_perm and one red.shared.add on the lane's "
                 "own 32-bit value-major counter, never cleared (a row's "
                 "bins are differences of sums), the present-value mask of "
                 "the same pass"),
    # not a Pallas kernel: the JAX estimators.ertl_mle is an XLA while
    # loop, the device branch of SketchBank.compute_cards
    # (cuda_selection_criteria_tpu/models/bank.py:80-104) and the dense
    # engines' union MLE
    "ertl_mle": (f"{PKG}/csrc/ertl_mle.cu",
                 "cuda_selection_criteria_tpu/ops/estimators.py:78",
                 "estimators.ertl_mle (an XLA while loop): one thread a "
                 "row, persistent two-warp CTAs, each warp staging 32 rows "
                 "with 4-byte cp.async copies all in flight into an odd "
                 "row stride, every operation a round-to-nearest "
                 "intrinsic, a log1p-branch flag a row"),
    # not a Pallas kernel: the JAX band_fingerprints is an XLA fusion, which
    # the JAX plan replaced by its host twin band_fingerprints_np
    "band_fingerprints": (
        f"{PKG}/csrc/band_fp.cu",
        "cuda_selection_criteria_tpu/parallel/screened.py:98",
        "band_fingerprints (an XLA fusion; the JAX plan ran its host twin): "
        "one thread a (sorted position, band), the row read through the "
        "plan's row map, 16-byte loads for an even band"),
    # not a Pallas kernel: the JAX unpack_place is a jitted XLA decode into
    # a donated buffer, the device half of the packed bank upload
    "regpack_unpack": (
        f"{PKG}/csrc/regpack_unpack.cu",
        "cuda_selection_criteria_tpu/ops/regpack.py:122",
        "unpack_place (a jitted XLA decode into a donated buffer): word "
        "path, one thread a 4-byte word of each of the k planes (32 "
        "registers, k a template parameter), index bits regrouped by "
        "constant shifts and LOP3 masks, the table in shared memory, "
        "__byte_perm merges, two 16-byte stores; byte path (ragged R/8 or "
        "an out 8 bytes off 16) one thread a byte of each plane"),
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
    counts (must be 0) and the hits. args: (regs, tiles, e, fp), tiles the
    launch's screen.LaunchTiles with one shared block list; kw may hold
    the bank's row_map, which the strip entry reads on both sides."""
    got = screen.screen_hits_fused(*args, **kw)
    regs, tiles, e, fp = args
    strip_kw = dict(kw, col_map=kw.get("row_map"))
    strip = screen.screen_hits_fused_strips(regs, regs, tiles, e, e, fp, fp,
                                            0, 0, **strip_kw)
    want = screen._screen_hits_fused_plain(regs, tiles.row_tiles,
                                           tiles.col_tiles, e, fp, **kw)
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
    (max |difference|, hits). args: (regs_rows, regs_cols, tiles, e_rows,
    e_cols, fp_rows, fp_cols, row_base, col_base), tiles the launch's
    screen.LaunchTiles."""
    got = screen.screen_hits_fused_strips(*args, **kw)
    regs_r, regs_c, tiles, *rest = args
    want = screen._screen_hits_fused_strips_plain(
        regs_r, regs_c, tiles.row_tiles, tiles.col_tiles, *rest, **kw)
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
        args = (t[0], t[3], screen.launch_tiles(r_t, c_t, False, dev), t[1],
                t[4], t[2], t[5], row_base, col_base)
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
    tiles = screen.launch_tiles([0, 0, 1, 2], [0, 2, 1, 2], True, dev)
    worst = 0
    cases = [(cb, smh, lo, 11, False) for cb in (True, False)
             for smh in (True, False) for lo in (0, 2)]
    cases.append((True, False, 0, 26, False))  # truncated value list
    # the plan's layout: the rows in another order, one zero row after
    # them, read through a map that sends the last positions to it
    cases += [(True, True, 2, 11, True), (False, False, 0, 11, True)]
    for use_cb, use_smh, lo, hi, mapped in cases:
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
        kw = dict(n_real=n - 5, tau_scr=0.4, tau_cb=0.35, p=p, values=vals,
                  ti=ti, n_bands=4, use_cb=use_cb, use_smh=use_smh)
        d_regs = torch.from_numpy(regs).to(dev)
        if mapped:
            perm = rng.permutation(n).astype(np.int32)
            perm[-5:] = n  # the padded positions read the zero row
            regs[-5:] = 0
            kw["values"] = vals = screen.bank_values(regs)
            bank = np.zeros((n + 1, 1 << p), np.uint8)
            bank[perm[:-5]] = regs[:-5]
            d_regs = torch.from_numpy(bank).to(dev)
            kw["row_map"] = torch.from_numpy(perm).to(dev)
        args = [d_regs, tiles, torch.from_numpy(e).to(dev),
                torch.from_numpy(fp).to(dev)]
        err, hits = kernel_vs_plain(torch, screen, args, kw)
        print(f"  p=8 ti=64 cb={use_cb} smh={use_smh} zeros={lo == 0} "
              f"bins={len(vals) - 1}{' through a row map' * mapped}: "
              f"hits={hits} max_abs_err={err}")
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
                screen.launch_tiles(rows, cols, True, dev),
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
    regs, tiles, e, fp = args
    rows, cols = tiles.row_tiles, tiles.col_tiles
    print(f"  K1 {label} p={kw['p']} ti={kw['ti']} tiles={len(rows)} "
          f"bins={nbins}: hits={hits} max_abs_err={err}")
    check(err == 0, f"K1 {label}: kernel != plain")
    check(hits > 0, f"K1 {label}: the comparison saw no hits")
    plain_ms = cuda_ms(torch, lambda: screen._screen_hits_fused_plain(
        regs, rows, cols, e, fp, **kw), 2)
    ms = cuda_ms(torch, lambda: screen.screen_hits_fused(*args, **kw), 5)
    ti, r = kw["ti"], regs.shape[1]
    g = screen._fused_gates(rows, cols, e, fp, kw["n_real"], kw["tau_scr"],
                            kw["tau_cb"], ti, kw["n_bands"], kw["use_cb"],
                            kw["use_smh"])[2]
    gated = int(g.sum())
    del g
    n_ids = int(torch.unique(torch.cat([rows, cols])).numel())
    bound_ms, bound_by = bound(gated * nbins * r / b1,
                               (len(rows) * ti * ti + n_ids * ti * r) / hbm)
    row_map = kw.get("row_map")  # the yardstick gets the sorted rows
    sorted_regs = regs if row_map is None else regs[row_map.long()]
    library_ms = int_mm_ms(torch, sorted_regs, rows, cols, kw["values"], ti,
                           ti)
    del sorted_regs
    ms2 = cuda_ms(torch, lambda: screen.screen_hits_fused(*args, **kw), 5)
    print(f"  [{card}] K1 {label}: {ms:.3f} / {ms2:.3f} ms (two turns) vs "
          f"plain {plain_ms:.3f} ms per launch; {gated} of "
          f"{len(rows) * ti * ti} pairs pass the gates; bound {bound_ms:.3f}"
          f" ms ({bound_by}), share of the bound {bound_ms / ms:.3f}; "
          f"library (torch._int_mm, {nbins} x {len(rows)} calls) "
          f"{library_ms:.3f} ms")
    pack = k1_pack(torch, screen, lambda: screen.screen_hits_fused(*args,
                                                                   **kw),
                   tiles, kw, r, card, label)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, pack=pack)


def k1_pack(torch, screen, launch, tiles, kw, r, card, label, reps=3):
    """The pack stage of a K1 launch (pack_planes_kernel, csrc/
    pack_planes.cuh) from a torch.profiler trace of `reps` launches: its
    device ms a launch, beside its bound (the launch's blocks' ti rows of
    r bytes read once and their planes written once, at HBM_BYTES_PER_S),
    and the plane scratch bytes of a launch: its LaunchTiles' distinct
    blocks (a shared list once), ti rows of nbins planes of
    plane_words(p) uint32 words each. A later profiler session of a
    process once came back with no device events though its launches ran
    (NVIDIA H100 80GB HBM3, torch 2.11): such a trace is taken again
    once, and a second empty one fails the run."""
    from cuda_selection_criteria_tpu_torch.utils.profiling import (
        device_trace)

    _, hbm = rates()
    launch()
    torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    for attempt in range(2):
        with device_trace() as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        pack_us, kernels = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type != cpu and "pack_planes_kernel" in ev.key:
                pack_us += ev.self_device_time_total
                kernels += ev.count
        if kernels:
            break
        print(f"  K1 {label}: the trace shows no pack_planes_kernel "
              f"(attempt {attempt + 1}); tracing again", flush=True)
    check(kernels > 0, f"K1 {label}: the trace shows no pack_planes_kernel")
    ti = kw["ti"]
    n_blocks = tiles.row_blocks.numel() + (
        0 if tiles.col_blocks is tiles.row_blocks
        else tiles.col_blocks.numel())
    scratch = (n_blocks * ti * (len(kw["values"]) - 1)
               * screen.plane_words(kw["p"]) * 4)
    pack_ms = pack_us / 1e3 / reps
    bound_ms = (n_blocks * ti * r + scratch) / hbm * 1e3
    print(f"  [{card}] K1 {label} pack stage: {pack_ms:.3f} ms a launch "
          f"({kernels // reps} pack_planes_kernel a launch), {n_blocks} "
          f"blocks of {ti} rows, plane scratch {scratch} bytes a launch; "
          f"bound {bound_ms:.3f} ms (bytes), share of the bound "
          f"{bound_ms / pack_ms:.3f}")
    return dict(ms=pack_ms, bound_ms=bound_ms, bound_by="bytes",
                blocks=n_blocks, scratch_bytes=scratch)


def k1_strips_config(torch, screen, plan, card):
    """K1's strip variant on the ring's shape: 64 tile pairs at p=14,
    ti=1024 between two 4096-row strips of the hll bench bank (sorted rows
    4096-8191 against sorted rows 8192-12287, each strip the plan's bank
    read through its slice of the plan's row map; its 16 tile pairs four
    times; the hll_a primary call: CB, no bands), against its plain
    version (bit-equal), timed beside it, its bound and torch._int_mm with
    a column bank (the strips' sorted rows); the bound as in k1_config."""
    b1, hbm = rates()
    ti, r = 1024, 1 << 14
    rows = slice(4096, 8192)
    cols = slice(8192, 12288)
    rr, cc = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    tiles = screen.launch_tiles(np.tile(rr.ravel(), 4), np.tile(cc.ravel(), 4),
                                False, plan.d_bank.device)
    r_t, c_t = tiles.row_tiles, tiles.col_tiles
    args = (plan.d_bank, plan.d_bank, tiles, plan.d_e[rows],
            plan.d_e[cols], plan.d_fp[rows], plan.d_fp[cols], 4096, 8192)
    kw = dict(n_real=plan.n, tau_scr=plan.tau_scr, tau_cb=plan.tau_cb, p=14,
              values=plan.values, ti=ti, n_bands=1, use_cb=True,
              use_smh=False, row_map=plan.d_rows[rows],
              col_map=plan.d_rows[cols])
    err, hits = strips_vs_plain(torch, screen, args, kw)
    nbins = len(kw["values"]) - 1
    print(f"  K1 strips dense (hll_a primary) p=14 ti={ti} tiles={len(r_t)} "
          f"bins={nbins}: hits={hits} max_abs_err={err}")
    check(err == 0, "K1 strips dense: kernel != plain")
    check(hits > 0, "K1 strips dense: the comparison saw no hits")
    plain_args = (args[0], args[1], r_t, c_t, *args[3:])
    plain_ms = cuda_ms(torch, lambda: screen._screen_hits_fused_strips_plain(
        *plain_args, **kw), 2)
    ms = cuda_ms(torch, lambda: screen.screen_hits_fused_strips(*args, **kw),
                 5)
    g = screen._strip_gates(r_t, c_t, args[3], args[4], args[5], args[6],
                            4096, 8192, kw["n_real"], kw["tau_scr"],
                            kw["tau_cb"], ti, 1, True, False)[2]
    gated = int(g.sum())
    del g
    bound_ms, bound_by = bound(gated * nbins * r / b1,
                               (len(r_t) * ti * ti + 8 * ti * r) / hbm)
    strip_r = plan.d_bank[kw["row_map"].long()]
    strip_c = plan.d_bank[kw["col_map"].long()]
    library_ms = int_mm_ms(torch, strip_r, r_t, c_t, kw["values"], ti, ti,
                           regs_cols=strip_c)
    del strip_r, strip_c
    ms2 = cuda_ms(torch, lambda: screen.screen_hits_fused_strips(*args, **kw),
                  5)
    print(f"  [{card}] K1 strips dense: {ms:.3f} / {ms2:.3f} ms (two turns) "
          f"vs plain {plain_ms:.3f} ms per launch; {gated} of "
          f"{len(r_t) * ti * ti} pairs pass the gates; bound {bound_ms:.3f} "
          f"ms ({bound_by}), share of the bound {bound_ms / ms:.3f}; library "
          f"(torch._int_mm, {nbins} x {len(r_t)} calls) {library_ms:.3f} ms")
    pack = k1_pack(torch, screen,
                   lambda: screen.screen_hits_fused_strips(*args, **kw),
                   tiles, kw, r, card, "strips dense")
    check(pack["blocks"] == 8, "K1 strips dense: not 4 + 4 blocks packed")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, pack=pack)


PRESENCE_RAGGED = (1 << 24) + 13  # uniform bytes with a ragged tail


def presence_vs_plain(torch, screen, d, label):
    """The presence kernel (bank_values on the card tensor d) against its
    plain version on the same tensor: (max |difference| of the two
    256-entry presence vectors, the kernel's values)."""
    got = screen.bank_values(d)
    want = screen._bank_values_plain(d.reshape(-1), 1 << 24)
    err = int(np.abs(np.isin(np.arange(256), got).astype(np.int64)
                     - np.isin(np.arange(256), want)).max())
    print(f"  presence {label}: {len(got)} values "
          f"{got[0]}..{got[-1]}, max_abs_err={err}")
    check(err == 0, f"presence {label}: kernel != plain")
    return err, got


def phase_presence_uniform(torch, screen, dev):
    """The presence kernel on uniform bytes 0-255 with a ragged tail, from
    an aligned start and from byte 1 (an unaligned head): every value
    present, as the plain version says."""
    x = np.random.default_rng(0x256).integers(0, 256, PRESENCE_RAGGED,
                                              dtype=np.uint8)
    d = torch.from_numpy(x).to(dev)
    worst = 0
    for off in (0, 1):
        err, got = presence_vs_plain(
            torch, screen, d[off:], f"uniform 0-255, {PRESENCE_RAGGED - off}"
            f" bytes from byte {off}")
        check(got == tuple(range(256)), "presence uniform: a value missing")
        worst = max(worst, err)
    return worst


def presence_config(torch, screen, d, card, label):
    """The presence kernel on the card tensor d (a bank's real rows)
    against its plain version (bit-equal presence), timed beside it, its
    bound (the bytes read once at HBM_BYTES_PER_S against one comparison a
    byte at INT32_OPS_PER_S) and the library yardstick: one torch.bincount
    of the uint8 bytes, with no cast (torch.unique, which sorts with CUB,
    refuses 2^31 elements), its non-zero bins checked against the
    kernel's values first. The plain version is the chunked, int32-cast
    bincount loop that CPU tensors run."""
    from cuda_selection_criteria_tpu_torch.utils import hopper

    err, got = presence_vs_plain(torch, screen, d, label)
    flat = d.reshape(-1)
    chunk = 1 << 24

    def bincount():
        return torch.bincount(flat, minlength=256)

    lib = tuple(torch.nonzero(bincount()).view(-1).tolist())
    check(lib == got, f"presence {label}: torch.bincount's values differ")
    ms = cuda_ms(torch, lambda: screen.bank_values(d), 10)
    plain_ms = cuda_ms(torch, lambda: screen._bank_values_plain(flat, chunk),
                       2)
    library_ms = cuda_ms(torch, bincount, 2)
    ms2 = cuda_ms(torch, lambda: screen.bank_values(d), 10)
    bound_ms, bound_by = bound(flat.numel() / hopper.INT32_OPS_PER_S,
                               (flat.numel() + 32) / hopper.HBM_BYTES_PER_S)
    print(f"  [{card}] presence {label} ({flat.numel()} bytes): {ms:.3f} / "
          f"{ms2:.3f} ms (two turns, with the 32-byte read-back) vs plain "
          f"{plain_ms:.3f} ms; bound {bound_ms:.3f} ms ({bound_by}), share "
          f"of the bound {bound_ms / ms:.3f}; library (one torch.bincount "
          f"of the uint8 bytes) {library_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, bytes=flat.numel())


def row_hist_vs_plain(torch, screen, d, label):
    """The row-histogram kernel (row_hist on the card tensor d) against
    its plain version on the same tensor: (max |difference| over the
    histograms and the 256-entry presence vectors, the kernel's histograms
    and values)."""
    got, vals = screen.row_hist(d)
    want, want_vals = screen._row_hist_plain(d, 2048)
    torch.cuda.synchronize()
    err = int(np.abs(np.isin(np.arange(256), vals).astype(np.int64)
                     - np.isin(np.arange(256), want_vals)).max())
    if got.numel():
        err = max(err, int((got.to(torch.int64) - want.to(torch.int64))
                           .abs().max()))
    print(f"  row_hist {label}: {d.shape[0]} rows of {d.shape[1]}, "
          f"{len(vals)} values {vals[:1]}..{vals[-1:]}, max_abs_err={err}")
    check(err == 0, f"row_hist {label}: kernel != plain")
    check(got.dtype == torch.int32 and got.shape == (d.shape[0], 64),
          f"row_hist {label}: histograms of the wrong shape")
    return err, got, vals


def hll_like(rng, n, r, top):
    """uint8 (n, r) registers skewed as HLL rows of 2048 hashes at p=14
    (about 12% non-zero, geometric values), capped at `top`."""
    hit = rng.random((n, r)) < 0.12
    vals = np.minimum(rng.geometric(0.5, (n, r)), top)
    return np.where(hit, vals, 0).astype(np.uint8)


def numpy_row_bincounts(regs, chunk=1 << 27):
    """numpy's bincount of each row of a host uint8 (n, r) array, a row in
    chunks of `chunk` bytes (np.bincount casts to int64): int64 (n, 64)."""
    return np.stack([sum(np.bincount(row[c:c + chunk], minlength=64)
                         for c in range(0, len(row), chunk))
                     for row in regs])


def phase_row_hist_edges(torch, screen, synth, dev):
    """The row-histogram kernel against its plain version and numpy's row
    bincounts where its design has edges: 1001 skewed rows at p=14 with
    all-zero rows and the HLL maximum 64 - 14 + 1 (1001 rows: not a
    multiple of the CTA's 4), rows of 100 registers (not 16 bytes a lane;
    every row starts at another alignment), rows of 48 uniform values
    0..63, 1001 dense rows of real-sized genomes at p=14 (synth.genome_regs:
    no zero byte), 64 rows of 2^14 bytes of one value each, 0..63 (a lane's
    counts all on one counter), 9 rows of 2^14 from byte 1 of a buffer
    (unaligned heads and tails), one row of 2^31 - 1 uniform bytes 0..63
    (the largest R an int holds), then a row of 2^31 bytes and a byte of
    64, which both raise ValueError (the byte from both versions)."""
    rng = np.random.default_rng(0x4157)
    worst = 0
    skewed = hll_like(rng, 1001, 1 << 14, 51)
    skewed[[0, 500, 1000]] = 0
    skewed[7, 99] = 51
    dense = synth.genome_regs(torch, 1001, 14, 0x4157, dev)
    cases = [("skewed p=14 with zero rows", torch.from_numpy(skewed).to(dev)),
             ("R=100", torch.from_numpy(hll_like(rng, 13, 100, 51)).to(dev)),
             ("R=48 uniform 0..63", torch.from_numpy(rng.integers(
                 0, 64, (37, 48), dtype=np.uint8)).to(dev)),
             ("dense genome rows p=14", dense),
             ("one value a row p=14", torch.arange(
                 64, dtype=torch.uint8, device=dev)[:, None].repeat(
                     1, 1 << 14)),
             ("one row of 2^31 - 1", torch.randint(
                 0, 64, (1, (1 << 31) - 1), dtype=torch.uint8, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(31)))]
    for label, d in cases:
        err, got, _ = row_hist_vs_plain(torch, screen, d, label)
        check(np.array_equal(got.cpu().numpy(),
                             numpy_row_bincounts(d.cpu().numpy())),
              f"row_hist {label}: != numpy's row bincounts")
        worst = max(worst, err)
    del cases, d
    torch.cuda.empty_cache()
    flat = torch.from_numpy(hll_like(rng, 1, 9 * (1 << 14) + 1, 51)
                            .reshape(-1)).to(dev)
    err, _, _ = row_hist_vs_plain(torch, screen,
                                  flat[1:].view(9, 1 << 14),
                                  "9 rows from byte 1")
    worst = max(worst, err)
    before = screen.row_hist.launches
    try:
        screen.row_hist(torch.zeros((1, 1 << 31), dtype=torch.uint8,
                                    device=dev))
    except ValueError as exc:
        print(f"  row_hist a row of 2^31: ValueError ({exc})")
    else:
        check(False, "row_hist took a row of 2^31 registers")
    check(screen.row_hist.launches == before,
          "row_hist launched on a row of 2^31 registers")
    torch.cuda.empty_cache()
    bad = torch.from_numpy(hll_like(rng, 24, 1 << 14, 51)).to(dev)
    bad[17, 4321] = 64
    for fn in (screen.row_hist, lambda d: screen._row_hist_plain(d, 2048)):
        try:
            fn(bad)
        except ValueError as exc:
            print(f"  row_hist a byte of 64: ValueError ({exc})")
        else:
            check(False, "row_hist took a register value of 64")
    return worst


def row_hist_config(torch, screen, d, card, label, library=True):
    """The row-histogram kernel on the card tensor d (a bank's rows)
    against its plain version (bit-equal histograms and values), timed
    beside it, its bound (the bytes read once and the histograms written
    once at HBM_BYTES_PER_S, against one comparison a byte at
    INT32_OPS_PER_S) and, with library, the library yardstick: one
    torch.bincount of row * 64 + reg with its int64 index (the cast and
    the add timed with it), its histograms checked against the kernel's
    first. The plain version is the 2048-row bincount loop that CPU
    tensors run. Returns (record, the kernel's histograms)."""
    from cuda_selection_criteria_tpu_torch.utils import hopper

    err, got, _ = row_hist_vs_plain(torch, screen, d, label)
    n, r = d.shape
    offs = torch.arange(n, device=d.device, dtype=torch.int64)[:, None] * 64

    def bincount():
        return torch.bincount((d.to(torch.int64) + offs).view(-1),
                              minlength=n * 64).view(n, 64)

    library_ms = None
    if library:
        check(torch.equal(bincount().to(torch.int32), got),
              f"row_hist {label}: torch.bincount's histograms differ")
    ms = cuda_ms(torch, lambda: screen.row_hist(d), 10)
    plain_ms = cuda_ms(torch, lambda: screen._row_hist_plain(d, 2048), 2)
    if library:
        library_ms = cuda_ms(torch, bincount, 2)
    ms2 = cuda_ms(torch, lambda: screen.row_hist(d), 10)
    bound_ms, bound_by = bound(n * r / hopper.INT32_OPS_PER_S,
                               (n * r + n * 256 + 32)
                               / hopper.HBM_BYTES_PER_S)
    lib = (f"{library_ms:.3f} ms" if library else
           f"not timed (its int64 index would hold {n * r * 8 / 2**30:.0f} "
           "GiB)")
    print(f"  [{card}] row_hist {label} ({n} x {r} bytes): {ms:.3f} / "
          f"{ms2:.3f} ms (two turns, with the 32-byte read-back) vs plain "
          f"{plain_ms:.3f} ms; bound {bound_ms:.3f} ms ({bound_by}), share "
          f"of the bound {bound_ms / ms:.3f}; library (one torch.bincount of "
          f"row * 64 + reg) {lib}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                bytes=n * r), got


# The band-fingerprint kernel's splits (m, n_rows, n_bands):
# criteria.smh_band_params' at tau 0.5, 0.8 and 0.9 for m = 8, 32, 64 and
# 256, and its (1, m) fallback (one-word loads); its timed shape is
# smh_a-524k's: 524,288 rows of m = 32 words at tau 0.9 (4 rows x 8 bands).
BAND_FP_SPLITS = ((8, 1, 8), (8, 2, 4), (32, 1, 32), (32, 2, 16),
                  (32, 4, 8), (64, 1, 64), (64, 2, 32), (64, 4, 16),
                  (64, 8, 8), (256, 1, 256), (256, 4, 64), (256, 8, 32),
                  (256, 16, 16))
BAND_FP_N = 1 << 19


def band_fp_layout(rng, n, m, n_pad):
    """uint64 (n, m) words over the whole 64-bit range (top bits set, an
    all-ones row, a zero row, rows sharing row 0's words) in the plan's
    layout: (the bank in its own row order with one zero row after it, the
    int32 map of a shuffled order whose padded positions name the zero
    row, the host-sorted zero-padded aux the JAX plan fingerprints)."""
    aux = rng.integers(0, 1 << 64, size=(n, m), dtype=np.uint64)
    aux[1::5] = aux[0]
    aux[3] = np.uint64(0xFFFFFFFFFFFFFFFF)
    aux[4] = 0
    order = rng.permutation(n)
    bank = np.zeros((n + 1, m), np.uint64)
    bank[:n] = aux
    rows = np.full(n_pad, n, np.int32)
    rows[:n] = order
    aux_p = np.zeros((n_pad, m), np.uint64)
    aux_p[:n] = aux[order]
    return bank, rows, aux_p


def band_fp_vs_plain(torch, screened, d_aux, d_rows, aux_p, n_rows, n_bands,
                     label):
    """The band-fingerprint kernel (band_fingerprints on the card tensors)
    against its plain version on the same tensors and against
    band_fingerprints_np of the host-sorted, zero-padded aux: the max
    |difference| (must be 0)."""
    got = screened.band_fingerprints(d_aux, d_rows, n_rows, n_bands)
    want = screened._band_fingerprints_plain(d_aux, d_rows, n_rows, n_bands)
    torch.cuda.synchronize()
    check(got.dtype == torch.int32 and got.shape == (len(d_rows), n_bands),
          f"band_fingerprints {label}: fingerprints of the wrong shape")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    np_err = int(np.abs(got.cpu().numpy().astype(np.int64)
                        - screened.band_fingerprints_np(aux_p, n_rows,
                                                        n_bands)).max())
    print(f"  band_fingerprints {label}: {len(d_rows)} positions x "
          f"{n_bands} bands of {n_rows} words, max_abs_err={err} (plain), "
          f"{np_err} (band_fingerprints_np)")
    check(err == 0 and np_err == 0,
          f"band_fingerprints {label}: kernel != plain / numpy")
    return err


def phase_band_fp_edges(torch, screened, dev):
    """The band-fingerprint kernel at every split of BAND_FP_SPLITS on 37
    rows padded to 48 positions (the zero row), and on a bank that starts
    8 bytes past a 16-byte boundary (the one-word loads at an even band)."""
    rng = np.random.default_rng(0xF1)
    worst = 0
    for m, n_rows, n_bands in BAND_FP_SPLITS:
        bank, rows, aux_p = band_fp_layout(rng, 37, m, 48)
        worst = max(worst, band_fp_vs_plain(
            torch, screened, torch.from_numpy(bank.view(np.int64)).to(dev),
            torch.from_numpy(rows).to(dev), aux_p, n_rows, n_bands,
            f"m={m}"))
    bank, rows, aux_p = band_fp_layout(rng, 999, 32, 1024)
    d = torch.from_numpy(bank.view(np.int64)).to(dev)
    flat = torch.empty(d.numel() + 1, dtype=torch.int64, device=dev)
    shifted = flat[1:].view(d.shape)
    shifted.copy_(d)
    check(shifted.data_ptr() % 16 == 8, "band_fingerprints: the shifted "
          "bank is 16-byte aligned")
    return max(worst, band_fp_vs_plain(
        torch, screened, shifted, torch.from_numpy(rows).to(dev), aux_p, 4,
        8, "m=32 from byte 8"))


def band_fp_config(torch, screen, screened, dev, card):
    """The band-fingerprint kernel at smh_a-524k's shape (BAND_FP_N rows of
    m = 32, 4 rows x 8 bands, a shuffled map) against its plain version and
    band_fingerprints_np, timed beside them: the launch alone and the
    wrapper (with its check of the map's range, a 2 x 4-byte read-back),
    its plain version, and its bound (the aux rows and the map read once
    and the fingerprints written once at HBM_BYTES_PER_S, against four
    integer operations a word at INT32_OPS_PER_S). No single PyTorch call
    computes the fingerprints (library_ms null)."""
    from cuda_selection_criteria_tpu_torch.utils import hopper

    n, m, n_rows, n_bands = BAND_FP_N, 32, 4, 8
    bank, rows, aux_p = band_fp_layout(np.random.default_rng(0x524), n, m,
                                       n)
    d_aux = torch.from_numpy(bank.view(np.int64)).to(dev)
    d_rows = torch.from_numpy(rows).to(dev)
    label = f"N={n} m={m}"
    err = band_fp_vs_plain(torch, screened, d_aux, d_rows, aux_p, n_rows,
                           n_bands, label)
    out = torch.empty((n, n_bands), dtype=torch.int32, device=dev)

    def launch():
        screen._launch("band_fp", dev, d_aux.data_ptr(), m,
                       d_rows.data_ptr(), n, n_rows, n_bands, out.data_ptr())

    launch()
    check(torch.equal(out, screened.band_fingerprints(
        d_aux, d_rows, n_rows, n_bands)), f"band_fingerprints {label}: the "
          "launch alone differs from the wrapper")
    ms = cuda_ms(torch, launch, 20)
    wrapper_ms = cuda_ms(torch, lambda: screened.band_fingerprints(
        d_aux, d_rows, n_rows, n_bands), 10)
    plain_ms = cuda_ms(torch, lambda: screened._band_fingerprints_plain(
        d_aux, d_rows, n_rows, n_bands), 2)
    ms2 = cuda_ms(torch, launch, 20)
    nbytes = n * m * 8 + n * 4 + n * n_bands * 4
    bound_ms, bound_by = bound(4 * n * m / hopper.INT32_OPS_PER_S,
                               nbytes / hopper.HBM_BYTES_PER_S)
    print(f"  [{card}] band_fingerprints {label} ({n_rows} rows x {n_bands} "
          f"bands, {nbytes} bytes): {ms:.4f} / {ms2:.4f} ms (two turns, the "
          f"launch alone), wrapper {wrapper_ms:.4f} ms (with the map's "
          f"range check) vs plain {plain_ms:.3f} ms; bound {bound_ms:.4f} "
          f"ms ({bound_by}), share of the bound {bound_ms / ms:.3f}; "
          "library none")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, wrapper_ms=wrapper_ms,
                ms2=ms2, bytes=nbytes)


def check_plan_fp(torch, screened, plan, bank, card, label):
    """A smh plan's d_fp, from its unsorted device aux bank through d_rows,
    bit-equal to band_fingerprints_np of the host-sorted, zero-padded aux
    (the JAX plan's route); no sorted host aux gathered."""
    from cuda_selection_criteria_tpu_torch.ops import criteria

    n_rows, n_bands = criteria.smh_band_params(bank.aux_param,
                                               plan.params.tau)
    aux_p = np.zeros((plan.n_pad, bank.aux.shape[1]), np.uint64)
    aux_p[:plan.n] = bank.aux[plan.order]
    want = screened.band_fingerprints_np(aux_p, n_rows, n_bands)
    check(np.array_equal(plan.d_fp.cpu().numpy(), want), f"{label}: the "
          "plan's d_fp differs from band_fingerprints_np")
    check(plan.aux_s is None, f"{label}: the plan gathered the sorted "
          "host aux")
    print(f"  [{card}] {label}: d_fp ({plan.n_pad} x {n_bands}) bit-equal "
          "to band_fingerprints_np of the host-sorted, zero-padded aux; "
          f"fp_secs {plan.fp_secs:.4f} s (upload, pass, free)")


# The unpack kernel's cases (k, rows, registers a row, i0, alphabet without
# 0), as tests/test_torch_kernels_cuda.py has them: odd row counts, i0 >
# 0; rows of 1, 17 and 2049 bytes a plane (R/8 not a multiple of 4) take
# the byte path, the others the word path, k = 1 to 7 on each; 2100 rows
# of 513 words a plane, so the grid stride (256 threads times the CTAs)
# is no multiple of a row's words and the groups outrun it. Its timed
# slab is the packed upload's: 8192 rows of 2^14 registers, 128 MiB.
UNPACK_CASES = [(1, 7, 136, 3, False), (2, 9, 8, 1, True),
                (3, 33, 16384, 5, True), (4, 101, 512, 0, False),
                (5, 5, 136, 11, True), (6, 65, 16392, 2, False),
                (7, 3, 1024, 9, True), (1, 9, 1024, 4, False),
                (2, 17, 4096, 2, True), (5, 40, 16384, 3, False),
                (6, 21, 2048, 7, True), (4, 2100, 16416, 1, False)]
UNPACK_SLAB_ROWS = 8192


def unpack_bank(torch, n, r, dev, offset=0, fill=7):
    """An (n, r) uint8 bank of `fill` on the card whose base lies `offset`
    bytes past a 16-byte boundary (a view of a larger buffer)."""
    flat = torch.full((n * r + 16,), fill, dtype=torch.uint8, device=dev)
    return flat[offset:offset + n * r].view(n, r)


def unpack_vs_plain(torch, regpack, rows, i0, dev, label, offset=0):
    """The unpack kernel (regpack.unpack_rows) against its plain version on
    the planes of the host rows, packed with their own alphabet and
    decoded into rows i0 .. of a bank of sevens `offset` bytes past a
    16-byte boundary: (max |difference|, the card's planes, table and k).
    Both must give the host rows, on the path the shape and alignment
    give (the word path for rows of a multiple of 32 registers on a
    16-byte boundary)."""
    lut, table, k = regpack.plan_pack(regpack.host_values(rows))
    packed = torch.from_numpy(regpack.pack_rows(rows, lut, k)).to(dev)
    d_table = torch.from_numpy(table).to(dev)
    r = rows.shape[1]
    got = unpack_bank(torch, i0 + len(rows) + 2, r, dev, offset)
    path = regpack.unpack_path(got, packed, i0)
    want_path = ("word" if r % 32 == 0 and (offset + i0 * r) % 16 == 0
                 else "byte")
    check(path == want_path, f"regpack_unpack {label}: the {path} path, "
          f"not the {want_path} path")
    want = regpack._unpack_rows_plain(got.clone(), packed, d_table, i0, k)
    regpack.unpack_rows(got, packed, d_table, i0, k)
    torch.cuda.synchronize()
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    check(np.array_equal(got[i0:i0 + len(rows)].cpu().numpy(), rows),
          f"regpack_unpack {label}: the decoded rows differ from the host's")
    print(f"  regpack_unpack {label} (k={k}, {len(rows)} rows of "
          f"{r} registers at row {i0}, {path} path): max_abs_err={err}")
    check(err == 0, f"regpack_unpack {label}: kernel != plain")
    del got, want
    return err, packed, d_table, k


def phase_unpack_edges(torch, regpack, dev):
    """The unpack kernel's cases (UNPACK_CASES), each alphabet of 2^k - 1
    values (2 at k = 1) drawn from a seed; then word-path shapes at k = 1,
    5, 6 and 7 in banks 8 bytes past a 16-byte boundary (the byte
    path)."""
    worst = 0
    cases = [(c, 0) for c in UNPACK_CASES] + [
        ((k, 33, 16384, 2, False), 8) for k in (1, 5, 6, 7)]
    for (k, s, r, i0, no_zero), offset in cases:
        rng = np.random.default_rng(k * 1000 + r)
        vals = rng.choice(np.arange(int(no_zero), 256), (1 << k) - (k > 1),
                          replace=False).astype(np.uint8)
        rows = rng.choice(vals, size=(s, r))
        label = (f"k={k}{' no zero' if no_zero else ''}"
                 f"{' 8-byte aligned bank' if offset else ''}")
        err, *_, kk = unpack_vs_plain(torch, regpack, rows, i0, dev, label,
                                      offset)
        check(kk == k, f"regpack_unpack {label}: the plan took k={kk}")
        worst = max(worst, err)
    return worst


def unpack_config(torch, regpack, rows, dev, card, label):
    """The unpack kernel on one 128 MiB slab of the packed upload (the host
    rows, packed with their own alphabet): bit-equal to its plain version,
    timed beside it (the wrapper, 20 launches a turn, two turns) and its
    bound (the larger of the planes read once and the registers written
    once at HBM_BYTES_PER_S and k + 1 integer operations a register at
    INT32_OPS_PER_S), on the word path (the bank on a 16-byte boundary)
    and, between the turns, on the byte path (the bank 8 bytes off it).
    No single PyTorch call decodes bit-planes (library_ms null)."""
    from cuda_selection_criteria_tpu_torch.utils import hopper

    err, packed, d_table, k = unpack_vs_plain(torch, regpack, rows, 0, dev,
                                              label)
    s, r = rows.shape
    out = torch.empty((s, r), dtype=torch.uint8, device=dev)
    off = unpack_bank(torch, s, r, dev, 8)
    want = torch.empty_like(out)
    check(regpack.unpack_path(out, packed, 0) == "word"
          and regpack.unpack_path(off, packed, 0) == "byte",
          f"regpack_unpack {label}: the paths of the timed banks")

    def launch(bank):
        return lambda: regpack.unpack_rows(bank, packed, d_table, 0, k)

    ms = cuda_ms(torch, launch(out), 20)
    plain_ms = cuda_ms(torch, lambda: regpack._unpack_rows_plain(
        want, packed, d_table, 0, k), 2)
    byte_ms = cuda_ms(torch, launch(off), 20)
    ms2 = cuda_ms(torch, launch(out), 20)
    check(torch.equal(out, want) and torch.equal(off, want),
          f"regpack_unpack {label}: the timed launches differ from plain")
    nbytes = packed.numel() + d_table.numel() + out.numel()
    bound_ms, bound_by = bound((k + 1) * out.numel() / hopper.INT32_OPS_PER_S,
                               nbytes / hopper.HBM_BYTES_PER_S)
    print(f"  [{card}] regpack_unpack {label} (k={k}, {s} x {r}, {nbytes} "
          f"bytes): word path {ms:.4f} / {ms2:.4f} ms (two turns), byte "
          f"path {byte_ms:.4f} ms, vs plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}), share of the bound "
          f"{bound_ms / max(ms, ms2):.3f} (byte path "
          f"{bound_ms / byte_ms:.3f}); library none")
    del out, off, want, packed
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, ms2=ms2, byte_ms=byte_ms,
                k=k, bytes=nbytes)


def phase_unpack(torch, regpack, bank_regs, dev, card):
    """The unpack kernel in phase 3: its cases (phase_unpack_edges), then
    timed (unpack_config) on the first 128 MiB slab of the N=16384 bench
    bank, the packed upload's slab and alphabet on the main path, and on a
    slab of 2^14-register rows over 33 values (k = 6). Returns (the worst
    max |difference|, the bench slab's record with the k = 6 slab's
    beside it)."""
    err = phase_unpack_edges(torch, regpack, dev)
    rec = unpack_config(torch, regpack, bank_regs[:UNPACK_SLAB_ROWS], dev,
                        card, "bench bank slab")
    rng = np.random.default_rng(0x6B)
    vals = rng.choice(64, 33, replace=False).astype(np.uint8)
    rec["k6"] = unpack_config(torch, regpack, rng.choice(
        vals, size=(UNPACK_SLAB_ROWS, 1 << 14)), dev, card, "k=6 slab")
    check(rec["k6"]["k"] == 6, "regpack_unpack: the k = 6 slab took another k")
    return max(err, rec["max_abs_err"], rec["k6"]["max_abs_err"]), rec


def upload_split(plan):
    """A plan's upload as one dict: upload_secs, the presence scan and the
    upload_stats."""
    return dict(upload_secs=plan.upload_secs,
                presence_secs=plan.presence_secs, **plan.upload_stats)


def upload_turns(torch, screened, bank, params, dev, card, label, turns):
    """ScreenPlans of the bank on the routes `turns` (upload_pack values,
    e.g. raw, packed, packed, raw), each made after a synchronize and
    freed: their upload splits, each printed."""
    out = []
    for pack in turns:
        torch.cuda.synchronize()
        plan = screened.ScreenPlan(bank, params, 1024, dev, upload_pack=pack)
        out.append(dict(upload_split(plan), route="packed" if pack
                        else "raw"))
        del plan
        torch.cuda.empty_cache()
        print(f"  [{card}] {label} {out[-1]['route']} upload: "
              + json.dumps({k: v for k, v in out[-1].items()
                            if k != "route"}))
    return out


def phase_packed(torch, mods, bank, params, dev, card):
    """The packed upload's path on the N=16384 bench bank:
    select_pairs_screened(upload_pack=True) on a bank without cards, with
    the launch counts set to 0 just before it (the packed upload, the
    row-histogram kernel, the MLE, the fingerprints, the gate prune, K1
    and the confirm), its lines equal to the raw route's; then the upload
    split of both routes in turns (raw, packed, packed, raw). Returns
    ({kernel: launches} of the packed run, the splits)."""
    screen, screened = mods["screen"], mods["screened"]
    SketchBank = mods["SketchBank"]

    def fresh():
        return SketchBank(names=bank.names, regs=bank.regs, p=bank.p,
                          aux_kind=bank.aux_kind, aux=bank.aux,
                          aux_param=bank.aux_param)

    raw = screened.select_pairs_screened(fresh(), params, device=dev)
    reset_launches(screen)
    torch.cuda.synchronize()
    stats = {}
    t0 = time.perf_counter()
    out = screened.select_pairs_screened(fresh(), params, device=dev,
                                         stats=stats, upload_pack=True)
    wall = time.perf_counter() - t0
    launches = read_launches(screen)
    print(f"  [{card}] select_pairs_screened(upload_pack=True) -c "
          f"{params.criterion} N={bank.n}: wall {wall:.3f} s (plan "
          f"{stats['plan_secs']:.3f} s, upload {stats['upload_secs']:.4f} "
          f"s), {len(out)} pairs, equal to the raw route's {len(raw)}: "
          f"{out == raw}; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check(out == raw, "the packed route's lines differ from the raw route's")
    for name in ("regpack_unpack", "row_hist", "ertl_mle",
                 "band_fingerprints", "gate_counts", "screen_fused"):
        check(launches[name] > 0, f"the packed path never launched {name}")
    splits = upload_turns(torch, screened, bank, params, dev, card,
                          f"N={bank.n}", (None, True, True, None))
    return launches, splits


def mle_rows(hostref, synth, p, seed):
    """int64 histograms at p where the MLE kernel has edges: 1001 unions of
    seeded synthetic rows, 300 rows on the log1p branch (registers only at
    q-1, q and q+1, as phase 8's set), an empty row, a saturated one, one
    bin, zeros with saturated registers and two far bins: 1306 rows, not a
    multiple of the kernel's 128-row CTA."""
    rng = np.random.default_rng(seed)
    q, m = 64 - p, 1 << p
    regs = synth.synthetic_regs(256, rng.integers(50, 200_000, 256), p, rng)
    unions = hostref.pair_union_histograms_np(
        regs, *rng.integers(0, 256, size=(2, 1001)))
    deg = np.zeros((300, 64), np.int64)
    deg[:, q] = rng.integers(1, m // 3, 300)
    deg[:, q - 1] = rng.integers(0, 3, 300)
    deg[:, q + 1] = m - deg[:, q] - deg[:, q - 1]
    edge = np.zeros((5, 64), np.int64)
    edge[0, 0] = m
    edge[1, q + 1] = m
    edge[2, 7] = m
    edge[3, 0], edge[3, q + 1] = m // 2, m - m // 2
    edge[4, 1], edge[4, q] = m - 3, 3
    return np.concatenate([unions, deg, edge])


def mle_vs_plain(torch, estimators, counts, p, dtype):
    """The MLE kernel on the card tensor `counts` against its plain version
    on the same tensor: (max |difference| of the estimates, inf against inf
    counting 0, plus the rows whose log1p flags differ; the kernel's
    estimates and flags)."""
    got, flags = estimators.ertl_mle(counts, p, dtype=dtype, branch=True)
    want = estimators._ertl_mle_plain(counts, p, dtype=dtype)
    want_flags = estimators.log1p_branch(counts, p, dtype)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    with np.errstate(invalid="ignore"):  # inf - inf where both are inf
        diff = np.where(same, 0.0, np.abs(g.astype(np.float64) - w))
    err = float(diff.max(initial=0.0)) + int((flags != want_flags).sum())
    check(got.dtype == dtype and got.shape == want.shape,
          "ertl_mle: estimates of the wrong dtype or shape")
    return err, got, flags


def phase_mle_edges(torch, estimators, models, hostref, synth, dev, card):
    """The MLE kernel against its plain version on mle_rows at p=8 and 14,
    read as int32, int64 and float32, in f64 and f32: bit-equal estimates
    and flags; the f64 estimates 0 ulp from hostref.ertl_mle_batch on every
    row off the log1p branch; then cards_from_hists on them bit-equal to
    the host MLE (bank.mle_rows) with its host rows. Returns the largest
    error."""
    worst = 0.0
    for p in (8, 14):
        h = mle_rows(hostref, synth, p, 0x3E70 + p)
        want = hostref.ertl_mle_batch(h, p)
        for in_dtype in (torch.int32, torch.int64, torch.float32):
            d = torch.from_numpy(h).to(dev, in_dtype)
            for dtype in (torch.float64, torch.float32):
                err, got, flags = mle_vs_plain(torch, estimators, d, p, dtype)
                worst = max(worst, err)
                check(err == 0, f"ertl_mle p={p} {in_dtype} {dtype}: kernel "
                      "!= plain")
                if dtype != torch.float64:
                    continue
                g, f = got.cpu().numpy(), flags.cpu().numpy()
                ulps = np.where(g == want, 0, np.abs(
                    g.view(np.int64) - want.view(np.int64)))
                check(ulps[~f].max() == 0, f"ertl_mle p={p}: the f64 kernel "
                      "is not 0 ulp from ertl_mle_batch off the log1p branch")
                if in_dtype == torch.int32:
                    print(f"  ertl_mle p={p}: {len(h)} rows, {int(f.sum())} "
                          f"on the log1p branch; kernel bit-equal to plain "
                          f"(int32, int64, f32 histograms; f64 and f32); f64 "
                          f"0 ulp from ertl_mle_batch on the {int((~f).sum())}"
                          f" rows off the branch, at most {int(ulps[f].max())}"
                          f" ulp on it")
        cards, host_rows = models.bank.cards_from_hists(
            torch.from_numpy(h).to(dev, torch.int32), p)
        check(np.array_equal(cards.view(np.int64), models.bank.mle_rows(
            h, p).view(np.int64)), f"cards_from_hists p={p} differs from "
              "the host MLE")
        print(f"  [{card}] cards_from_hists p={p}: bit-equal to the host MLE "
              f"on {len(h)} rows, {host_rows} recomputed on the host")
    return worst


def mle_config(torch, estimators, counts, p, dtype, card, label, branch):
    """The MLE kernel on the card tensor `counts` (the histograms a caller
    holds) against its plain version (bit-equal, through the wrapper),
    then the wrapper timed in two turns (20 calls each) and the plain
    version, beside the bound (experiments/mle_split.work_bound: the
    operations these rows' loops need, the plain version's work counter,
    at the card's FP64 or FP32 rate outside the tensor cores, against the
    q + 2 bins of each row read once and the estimates, and with branch
    the flags, written once). branch: with the log1p flags (the cards'
    call) or without (the dense engine's). Library: none (no PyTorch call
    computes this MLE). The launch alone and the ablation's variants are
    experiments/mle_split.py's. Returns the record."""
    from cuda_selection_criteria_tpu_torch.experiments import mle_split

    err, _, _ = mle_vs_plain(torch, estimators, counts, p, dtype)
    check(err == 0, f"ertl_mle {label}: kernel != plain")
    rows = counts.reshape(-1, counts.shape[-1])
    bound = mle_split.work_bound(rows, p, dtype, branch)

    def kernel():
        return estimators.ertl_mle(counts, p, dtype=dtype, branch=branch)

    ms = cuda_ms(torch, kernel, 20)
    plain_ms = cuda_ms(torch, lambda: estimators._ertl_mle_plain(
        counts, p, dtype=dtype), 2)
    ms2 = cuda_ms(torch, kernel, 20)
    print(f"  [{card}] ertl_mle {label} ({rows.shape[0]} rows, p={p}, "
          f"{str(counts.dtype)[6:]} in, {str(dtype)[6:]}"
          f"{', flags' if branch else ''}): wrapper {ms:.4f} / {ms2:.4f} ms "
          f"(two turns) vs plain {plain_ms:.3f} ms; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: {bound['ops']} "
          f"operations, {bound['secant_steps']} secant steps, "
          f"{bound['update_steps']} inner updates), share of the bound "
          f"{bound['bound_ms'] / ms:.3f}; library none")
    return dict(max_abs_err=err, ms=ms, ms2=ms2, plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                library_ms=None, rows=rows.shape[0], ops=bound["ops"],
                secant_steps=bound["secant_steps"])


def phase_mle(torch, estimators, pairwise, models, hostref, synth, hist,
              regs, aux, p_aux, dev, card):
    """The MLE kernel in phase 3: its edges (phase_mle_edges), then timed
    at the shapes its callers give it: the cards' call (f64 with flags) on
    the N=16384 bench bank's row histograms `hist`, on 524,288 rows (those
    histograms 32 times: the smh_a-524k cell's row count, rows of the same
    2048-hash shape) and on 524,288 rows of real-sized genomes
    (synth.genome_hists: 2^20 to 2^24 hashes, no zero register, longer
    secant loops), and the dense engine's calls (its default f32 on the
    card, and f64) on one 512 x 512 tile's union histograms of the sorted
    bench bank `regs` at p=14 and of its aux HLLs `aux` at p_aux. Returns
    (largest error, the 524,288-row record with the others beside it)."""
    err = phase_mle_edges(torch, estimators, models, hostref, synth, dev,
                          card)
    rec = mle_config(torch, estimators, hist.repeat(32, 1), 14,
                     torch.float64, card, "524,288 rows (the 16k bank's "
                     "histograms 32 times)", True)
    rec["n16k"] = mle_config(torch, estimators, hist, 14, torch.float64,
                             card, "N=16384 bench bank", True)
    genomes = torch.from_numpy(synth.genome_hists(
        1 << 19, 14, np.random.default_rng(0x6E0))).to(dev)
    rec["genomes"] = mle_config(torch, estimators, genomes, 14,
                                torch.float64, card, "524,288 real-genome "
                                "rows", True)
    del genomes
    unions = pairwise.union_histograms(regs[:512], regs[512:1024], 14)
    rec["tile_f32"] = mle_config(torch, estimators, unions, 14,
                                 torch.float32, card, "one 512 x 512 tile's "
                                 "unions", False)
    rec["tile_f64"] = mle_config(torch, estimators, unions, 14,
                                 torch.float64, card, "one 512 x 512 tile's "
                                 "unions", False)
    aux_unions = pairwise.union_histograms(aux[:512], aux[512:1024], p_aux)
    rec["aux_tile_f32"] = mle_config(torch, estimators, aux_unions, p_aux,
                                     torch.float32, card, "one 512 x 512 "
                                     "tile's aux unions", False)
    worst = max(err, *(r["max_abs_err"] for r in (
        rec, rec["n16k"], rec["genomes"], rec["tile_f32"], rec["tile_f64"],
        rec["aux_tile_f32"])))
    return worst, rec


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
          f"{launches['gate_counts']}, value_presence launches "
          f"{launches['value_presence']}, row_hist launches "
          f"{launches['row_hist']}, ertl_mle launches "
          f"{launches['ertl_mle']} (cards_host_rows "
          f"{stats['cards_host_rows']}, cards {stats['cards_secs']:.4f} s), "
          f"band_fingerprints launches {launches['band_fingerprints']} "
          f"(fp {stats['fp_secs']:.4f} s), "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return out, launches


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
    from cuda_selection_criteria_tpu_torch.utils import fasta, hostref, synth

    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    with contextlib.nullcontext(tmp_dir) as tmp:
        t0 = time.perf_counter()
        files, near, far, bases = synth.write_fasta_corpus(tmp, **corpus_kw)
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


CLI_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from cuda_selection_criteria_tpu_torch.cli import selection
from cuda_selection_criteria_tpu_torch.utils import hostmem
before = hostmem._enabled
rc = selection.main(sys.argv[2:])
print(json.dumps({"rc": rc, "before": before, "after": hostmem._enabled}))
"""


def cli_calls_hostmem(lst, want, dev, card):
    """Phase 4's selection -c smh_a in a fresh interpreter: its lines equal
    the host reference's, and the CLI's main switched the allocator to
    arena reuse (utils/hostmem._enabled set; None before main)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_CHILD, HERE, "-l", lst, "-a", "256", "-h",
         "0.9", "-c", "smh_a", "--device", str(dev)], capture_output=True,
        text=True, timeout=600)
    check(proc.returncode == 0, f"selection in a fresh process exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    *lines, last = proc.stdout.splitlines()
    state = json.loads(last)
    print(f"  [{card}] selection -c smh_a in a fresh process: {len(lines)} "
          f"lines in {time.perf_counter() - t0:.1f} s; hostmem._enabled "
          f"{state['before']} before main, {state['after']} after")
    check(state["rc"] == 0 and lines == want, "selection in a fresh process "
          "differs from the host reference")
    check(state["before"] is None and state["after"] is not None,
          "the selection CLI did not call hostmem.enable_arena_reuse")


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
    reset_launches(screen)
    torch.cuda.synchronize()
    stats = {}
    t0 = time.perf_counter()
    out = mods["select_pairs"](bank, params, device=dev, stats=stats)
    wall = time.perf_counter() - t0
    k_launches = (screen.screen_hits_fused.launches,
                  screen.screen_s_z.launches)
    mle_launches = estimators.ertl_mle.launches
    check(mle_launches >= stats["tiles"], f"dense -c {crit}: the engine "
          "did not launch the MLE kernel on every tile")
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
          f"{wall / s_wall:.1f}x); K1 / K2 launches {k_launches}; ertl_mle "
          f"launches {mle_launches}")

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
    return dict(wall=wall, screened_wall=s_wall, tile_ms=tile_ms,
                mle_launches=mle_launches, **split)


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
    check(res["pair unions"][0] == 0, "the card's f64 MLE (the kernel) is "
          "not 0 ulp from the host oracle's on pair unions, which take no "
          "log1p")
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


LAUNCH_KEYS = ("screen_fused", "strips", "weighted_cdf_sum", "gate_counts",
               "value_presence", "row_hist", "ertl_mle", "band_fingerprints",
               "regpack_unpack")


def reset_launches(screen):
    from cuda_selection_criteria_tpu_torch.ops import estimators, regpack
    from cuda_selection_criteria_tpu_torch.parallel import screened
    for fn in (screen.screen_hits_fused, screen.screen_hits_fused_strips,
               screen.screen_s_z, screen.gate_counts, screen.bank_values,
               screen.row_hist, estimators.ertl_mle,
               screened.band_fingerprints, regpack.unpack_rows):
        fn.launches = 0


def read_launches(screen):
    """{kernel: launches} since reset_launches (keys LAUNCH_KEYS); K1's two
    entry points launch the same kernel, "strips" counts the strip entry
    alone."""
    from cuda_selection_criteria_tpu_torch.ops import estimators, regpack
    from cuda_selection_criteria_tpu_torch.parallel import screened
    return {"screen_fused": screen.screen_hits_fused.launches
            + screen.screen_hits_fused_strips.launches,
            "strips": screen.screen_hits_fused_strips.launches,
            "weighted_cdf_sum": screen.screen_s_z.launches,
            "gate_counts": screen.gate_counts.launches,
            "value_presence": screen.bank_values.launches,
            "row_hist": screen.row_hist.launches,
            "ertl_mle": estimators.ertl_mle.launches,
            "band_fingerprints": screened.band_fingerprints.launches,
            "regpack_unpack": regpack.unpack_rows.launches}


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
        check(lr["value_presence"] > 0, f"ring -c {crit} never launched the "
              "presence kernel")
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
        check(ls["row_hist"] > 0, f"sharded -c {crit} never launched the "
              "row-histogram kernel")
        check(crit == "smh_a" or ls["value_presence"] > 0, f"sharded -c "
              f"{crit} never launched the presence kernel (the aux bank)")
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
    with 2^18 pairs, the default and the reject protocol. Returns
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
    K1's strip entry runs at this scale), pairs equal to 11b's; before 11b
    the presence kernel on the 11b bank against its plain version, timed
    (presence_config) and the row-histogram kernel (row_hist_config; its
    cards, through the MLE kernel (cards_from_hists), bit-equal to the host
    MLE of the same histograms and to the bank's). Returns ({kernel: launches} summed over
    the phase's runs, each read right after its own reset; the presence
    record; the row-histogram record; the packed plan's peak and the
    upload splits of both routes)."""
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
    d_regs = torch.from_numpy(bank.regs).to(dev)
    presence = presence_config(torch, screen, d_regs, card,
                               f"N={SCALE_N} bank")
    rows_2g, hist = row_hist_config(torch, screen, d_regs, card,
                                    f"N={SCALE_N} bank", library=False)
    # the cards of the card's histograms through the MLE kernel, bit-equal
    # to the host MLE of the same histograms; the harness's bank holds them
    # truncated (synth.bench_bank)
    cards, host_rows = mods["cards_from_hists"](hist, 14)
    check(np.array_equal(cards.view(np.int64), mods["mle_rows"](
        hist.cpu().numpy(), 14).view(np.int64)), "cards_from_hists of the "
          f"N={SCALE_N} bank differs from the host MLE")
    check(np.array_equal(bank.cards, np.trunc(cards)), "the cards of the "
          f"card's histograms differ from the N={SCALE_N} bank's")
    print(f"  [{card}] cards_from_hists N={SCALE_N}: bit-equal to the host "
          f"MLE, {host_rows} rows on the host")
    del d_regs, hist
    torch.cuda.empty_cache()
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
    check(launches["row_hist"] > 0, "validate_131k_scale never launched "
          "the row-histogram kernel")
    check(launches["band_fingerprints"] > 0, "validate_131k_scale never "
          "launched the band-fingerprint kernel")
    mods["verify_pairs"](bank, [(i, i + 1) for i in picks], pairs, "smh_a")
    add(launches)
    plan = mods["screened"].ScreenPlan(bank, params, 1024, dev)
    check_plan_fp(torch, mods["screened"], plan, bank, card,
                  f"plan N={SCALE_N} smh_a")
    # the packed upload of the same bank: its d_bank equal to the raw
    # plan's, its plan-stage peak taken on its own (above the raw bank
    # kept for the comparison) within the bank + 0.5 GiB
    raw_bank, splits = plan.d_bank, [dict(upload_split(plan), route="raw")]
    del plan
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches(screen)
    plan = mods["screened"].ScreenPlan(bank, params, 1024, dev,
                                       upload_pack=True)
    torch.cuda.synchronize()
    packed_peak = torch.cuda.max_memory_allocated() - held
    launches = read_launches(screen)
    splits.append(dict(upload_split(plan), route="packed"))
    equal = torch.equal(plan.d_bank, raw_bank)
    print(f"  [{card}] packed plan N={SCALE_N}: d_bank equal to the raw "
          f"plan's: {equal}; plan-stage peak {packed_peak / 2**30:.3f} GiB "
          f"beside the bank's {plan.d_bank.nbytes / 2**30:.3f} GiB (limit: "
          f"the bank + 0.5 GiB); regpack_unpack launches "
          f"{launches['regpack_unpack']}; raw upload "
          f"{json.dumps(splits[0])}; packed upload {json.dumps(splits[1])}")
    check(equal, f"the packed plan's d_bank N={SCALE_N} differs from the raw "
          "plan's")
    check(packed_peak <= plan.d_bank.nbytes + (1 << 29), "the packed plan "
          "stage held more than the bank + 0.5 GiB on the card")
    check(launches["regpack_unpack"] > 0, "the packed plan never launched "
          "the unpack kernel")
    add(launches)
    del plan, raw_bank
    torch.cuda.empty_cache()
    # the two routes again, the other way round (raw, packed | packed, raw)
    splits += upload_turns(torch, mods["screened"], bank, params, dev, card,
                           f"N={SCALE_N}", (True, None))
    packed = dict(plan_peak_allocated_bytes=packed_peak, uploads=splits)

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
    return total, presence, rows_2g, packed


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
    rows, cols = setup.span_tiles[setup.spans[0]][:2]
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
        setup.d_regs, *setup.span_tiles[span][:2], setup.d_e, setup.d_fp,
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
    t0 = time.perf_counter()
    ref = phase_reference(torch, mods["reference_kernel"], synth,
                          mods["host_cards"], bank, dev, card)
    print(f"  the reference kernel's step took {time.perf_counter() - t0:.1f}"
          " s")
    return launches, k2, ref


REF_N = 2048  # the reference kernel's comparison bank: phase 4's
REF_PREFIX = 1_000_003  # a prefix of its pair list that ends inside a CTA


def ref_union_bound(pairs, n, m, results):
    """(ms, "operations" or "bytes"): the least time of kernel_CBsmh's work
    on an N=n bank whose every listed pair reaches the union: each
    register of each union one byte max and one zero test on the INT32
    lanes and one f64 add at the FP64 rate (the gate's few compares left
    out), against the rows, buckets, cards and pairs read once and the
    results written once at HBM_BYTES_PER_S."""
    from cuda_selection_criteria_tpu_torch.utils import hopper
    regs = pairs * (1 << 14)
    ops_secs = max(2 * regs / hopper.INT32_OPS_PER_S,
                   regs / hopper.FP64_OPS_PER_S)
    nbytes = n * ((1 << 14) + 8 * m + 8) + 8 * pairs + 12 * results
    return bound(ops_secs, nbytes / hopper.HBM_BYTES_PER_S)


def ref_vs_plain(torch, reference_kernel, regs, aux, cards, tau, dev, label,
                 n_pairs=None):
    """The reference kernel against its plain version on one bank: the
    same sorted lines and bit-equal f32 sims, or the run fails. Returns
    (the lines' count, max |sim difference|)."""
    got = reference_kernel.reference_pairs(regs, aux, cards, tau, dev,
                                           n_pairs)
    want = reference_kernel.plain_lines(regs, aux, cards, tau, dev, n_pairs)
    check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]),
          f"reference kernel {label}: lines differ from plain")
    err = float(np.abs(got[2] - want[2]).max()) if len(got[2]) else 0.0
    check(np.array_equal(got[2], want[2]),
          f"reference kernel {label}: sims differ from plain by {err}")
    print(f"  reference kernel {label}: {len(got[0])} lines equal to plain, "
          "sims bit-equal")
    return len(got[0]), err


def phase_reference(torch, reference_kernel, synth, host_cards, bank, dev,
                    card):
    """Phase 12, step 2: the reference's own GPU kernel (experiments/
    reference_kernel.cu: kernel_CBsmh with hll_union_card, a measured
    baseline). At N=2048 on phase 4's bank (synth.planted_file_banks) it
    must give its plain version's lines with bit-equal sims, with the aux
    as drawn and with every aux row equal (every pair reaches the union),
    and on a prefix of REF_PREFIX pairs at tau -1 (every J kept); the
    union mode's launch timed beside the plain version and its bound. Then
    reference_kernel.rates on the N=16384 bench bank (bank: regs, aux, e):
    the gated whole triangle and a union prefix of at least 1 s a launch,
    beside utils/hopper.card_baseline; no whole union triangle here (the
    experiment's own run times it). Returns the kernels line's record."""
    regs, _, aux = synth.planted_file_banks(REF_N)
    cards = host_cards(regs, 14)
    check(regs.max() <= 39, "phase 4's bank has a register above 39: the "
          "kernel's sums would not be exact")
    aux_eq = np.broadcast_to(aux[:1], aux.shape)
    found, err1 = ref_vs_plain(torch, reference_kernel, regs, aux, cards,
                               0.9, dev, f"N={REF_N} aux as drawn")
    check(found >= 64, "the reference kernel missed planted pairs")
    _, err2 = ref_vs_plain(torch, reference_kernel, regs, aux_eq, cards, 0.9,
                           dev, f"N={REF_N} every aux row equal")
    kept, err3 = ref_vs_plain(torch, reference_kernel, regs, aux_eq, cards,
                              -1.0, dev, f"N={REF_N} every aux row equal, "
                              f"tau -1, first {REF_PREFIX} pairs", REF_PREFIX)
    check(kept == REF_PREFIX, "the reference kernel dropped a finite J")

    pairs = REF_N * (REF_N - 1) // 2
    prep = reference_kernel.prepare(regs, aux_eq, cards, 0.9, dev)
    ms = reference_kernel.launch_ms(prep, 0, pairs, 3)
    results = int(prep.count.item())
    t0 = time.perf_counter()
    plain = reference_kernel.reference_pairs_plain(
        prep.d_regs, prep.d_aux, prep.d_cards, 0.9, prep.n_rows,
        prep.n_bands, prep.d_pairs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(len(plain[0]) == results, "the reference kernel's count differs "
          "from its plain version's")
    del prep, plain
    bound_ms, bound_by = ref_union_bound(pairs, REF_N, aux.shape[1], results)
    print(f"  [{card}] reference kernel N={REF_N}, every pair through the "
          f"union ({pairs} pairs, {results} results): {ms:.3f} ms a launch "
          f"vs plain {plain_ms:.3f} ms; bound {bound_ms:.3f} ms "
          f"({bound_by}), share {bound_ms / ms:.4f}", flush=True)
    torch.cuda.empty_cache()

    regs16, aux16, e16 = bank
    reference_kernel.launch.launches = 0
    t0 = time.perf_counter()
    rates = reference_kernel.rates(regs16, aux16, e16.astype(np.float64),
                                   0.9, dev, max_triangle_secs=0.0)
    launches = reference_kernel.launch.launches
    print("  " + json.dumps(rates), flush=True)
    print(f"  [{card}] reference kernel N={len(regs16)}: ref_union_pairs_"
          f"per_sec {rates['ref_union_pairs_per_sec']:.6g} (first "
          f"{rates['ref_union_prefix_pairs']} pairs, "
          f"{rates['ref_union_prefix_launch_ms']:.1f} ms a launch), "
          f"ref_gated_pairs_per_sec {rates['ref_gated_pairs_per_sec']:.6g} "
          f"({rates['ref_gated_launch_ms']:.3f} ms a triangle); card_baseline "
          f"{rates['card_baseline']:.6g} pairs/s, share "
          f"{rates['ref_union_share_of_baseline']:.4f}; {launches} launches "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    check(rates["ref_union_prefix_launch_ms"] >= 1000.0,
          "the union prefix's launch took under 1 s")
    check(rates["ref_gated_pairs_per_sec"] > 0
          and rates["ref_union_pairs_per_sec"] > 0, "a rate is missing")
    check(launches > 0, "the rates run never launched the reference kernel")
    return dict(max_abs_err=max(err1, err2, err3), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, launches=launches,
                rates_16k=rates)


# Phase 14's sizes: a genome a row of real size (2^20 to 2^24 hashes), so CB
# prunes; the sub-collection held to the scalar select_pairs_host (its
# cost grows as N^2).
CLI_SCALE_N = 16384
CLI_SCALE_SUB = 4096


def phase_cli_scale(validate_cli_scale, screened, card):
    """Phase 14: experiments/validate_cli_scale.py at CLI_SCALE_N genomes
    with a cardinality spread and 256 planted pairs, its files in a
    temporary folder: the CLI in a fresh interpreter, the load by the
    native readers, cli.main in this process with its launches counted
    (the harness sets the counts to 0 just before it and reads them just
    after), every line held to the exact host cascade, the sub-collection
    of CLI_SCALE_SUB genomes equal to select_pairs_host. Returns
    {kernel: launches} of that run."""
    with tempfile.TemporaryDirectory() as tmp:
        try:
            rec = validate_cli_scale.main([
                "--n", str(CLI_SCALE_N), "--sub", str(CLI_SCALE_SUB),
                "--workdir", os.path.join(tmp, "cli_scale")])
        except validate_cli_scale.CheckFailed as exc:
            check(False, f"validate_cli_scale: {exc}")
    got = rec["launches"]
    print(f"  [{card}] selection -c smh_a N={rec['n']} from sketch files: "
          f"the user's wall {rec['cli_wall_secs']:.2f} s (fresh "
          f"interpreter), load {sum(rec['load_secs'].values()):.3f} s, "
          f"plan {rec['plan_secs']:.3f} s (upload {rec['upload_secs']:.3f}, "
          f"cards {rec['cards_secs']:.4f}, cards_host_rows "
          f"{rec['cards_host_rows']}), prune {rec['prune_secs']:.3f} s, "
          f"screen {rec['screen_secs']:.3f} s, confirm "
          f"{rec['confirm_secs']:.3f} s; tiles {rec['tiles_scheduled']} "
          f"scheduled / {rec['tiles_live']} live, {rec['lines']} lines, "
          f"planted recall {rec['planted_recall']}; launches {got}; the "
          f"CLI process's peak resident set {rec['child_rss_peak']}")
    check(rec["planted_recall"] == 1.0 and rec["lines"] > 0,
          "phase 14 recovered too few planted pairs")
    blocks = -(-CLI_SCALE_N // screened.auto_tile(CLI_SCALE_N))
    check(rec["tiles_scheduled"] < blocks * (blocks + 1) // 2,
          "phase 14: CB pruned no tile")
    for key, name in (("K1", "screen_fused"), ("G", "gate_counts"),
                      ("H", "row_hist"), ("M", "ertl_mle"),
                      ("F", "band_fingerprints")):
        check(got[key] > 0, f"phase 14's run never launched {name}")
    return {"screen_fused": got["K1"], "gate_counts": got["G"],
            "row_hist": got["H"], "ertl_mle": got["M"],
            "band_fingerprints": got["F"]}


def main():
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from cuda_selection_criteria_tpu_torch.utils import hostmem

    arena = hostmem.enable_arena_reuse()  # before torch allocates
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cuda_selection_criteria_tpu_torch import models
    from cuda_selection_criteria_tpu_torch.cli import selection as cli
    from cuda_selection_criteria_tpu_torch.experiments import (
        hostmem_split, mle_split, reference_kernel, validate_cli_scale)
    from cuda_selection_criteria_tpu_torch.native import fastx
    from cuda_selection_criteria_tpu_torch.ops import (_build, criteria,
                                                      estimators, pairwise,
                                                      regpack, screen)
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
    with ThreadPoolExecutor(2) as pool:
        host_lib = pool.submit(fastx.info)  # g++ builds while nvcc does
        ref_build = pool.submit(reference_kernel.build)
        for name, (path, build_secs, log) in _build.build().items():
            print(log.strip())
            print(f"built {os.path.relpath(path, HERE)} in {build_secs:.2f} s")
            spills = [ln for ln in log.splitlines() if "spill" in ln and
                      "0 bytes spill stores, 0 bytes spill loads" not in ln]
            check(not spills, f"{name}: ptxas spills registers: {spills}")
            check("serialized" not in log,
                  f"{name}: ptxas serializes the wgmma (see the log above)")
            if name in ("ertl_mle", "row_hist"):
                for ln in mle_split.ptxas_lines(log):
                    print(f"  {name} ptxas {ln}")
            _build.library(name)
        info = host_lib.result()
        ref_path, ref_secs, ref_log = ref_build.result()
    print(f"built {os.path.relpath(ref_path, HERE)} (the reference's "
          f"kernel_CBsmh, a measured baseline) in {ref_secs:.2f} s")
    for ln in mle_split.ptxas_lines(ref_log):
        print(f"  reference_kernel ptxas {ln}")
    spills = [ln for ln in ref_log.splitlines() if "spill" in ln and
              "0 bytes spill stores, 0 bytes spill loads" not in ln]
    check(not spills, f"reference_kernel: ptxas spills registers: {spills}")
    reference_kernel.library()
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
    args = [plan.d_bank,
            screen.launch_tiles(tri_r[:chunk], tri_c[:chunk], True, dev),
            plan.d_e, plan.d_fp]
    kw = dict(n_real=plan.n, tau_scr=plan.tau_scr, tau_cb=plan.tau_cb, p=14,
              values=plan.values, ti=1024, n_bands=plan.n_bands,
              use_cb=True, use_smh=True, row_map=plan.d_rows)
    hparams = SelectionParams(tau=0.9, criterion="hll_a")
    hplan = screened.ScreenPlan(hbank, hparams, 1024, device=dev)
    hr, hc = scheduler.triangle_block_ids(hplan.e_s, hplan.tau, 1024,
                                          use_cb_skip=False)
    h64 = screen.launch_tiles(hr[:chunk], hc[:chunk], True, dev)
    # dense: the hll primary call of _screen_chunk_hllaux (CB, no bands);
    # gated: the smh_a call (CB and LSH bands)
    k1 = {"dense": k1_config(
        torch, screen, "dense (hll_a primary)",
        [hplan.d_bank, h64, hplan.d_e, hplan.d_fp],
        dict(n_real=hplan.n, tau_scr=hplan.tau_scr, tau_cb=hplan.tau_cb,
             p=14, values=hplan.values, ti=1024, n_bands=1, use_cb=True,
             use_smh=False, row_map=hplan.d_rows), card)}
    k1["gated"] = k1_config(torch, screen, "gated (smh_a)", args, kw, card)
    k1["strips"] = k1_strips_config(torch, screen, hplan, card)
    max_err = max(max_err, k1["dense"]["max_abs_err"],
                  k1["gated"]["max_abs_err"], k1["strips"]["max_abs_err"])

    k2_err = max(phase_k2_small(torch, screen, dev),
                 phase_k2_edges(torch, screen, dev))
    k2_args = [hplan.d_aux_regs, h64.row_tiles, h64.col_tiles]
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
    k2_bound_ms, k2_bound_by = k2_bound(torch, *h64[:2], hplan.values_aux,
                                        8, 1024)
    k2_library_ms = int_mm_ms(torch, hplan.d_aux_regs, *h64[:2],
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
    presence_err = phase_presence_uniform(torch, screen, dev)
    rows_err = phase_row_hist_edges(torch, screen, synth, dev)
    # the plan's bank is the bench bank in its own row order, a zero row
    # after it; the plan set the bank's cards from these histograms
    rows_16k, hist = row_hist_config(torch, screen, plan.d_bank[:bank.n],
                                     card, f"N={bank.n} bench bank")
    check(np.array_equal(bank.cards.view(np.int64), models.bank.host_cards(
        bank.regs, 14).view(np.int64)), "the plan's cards (the card's "
          "histograms) differ from host_cards")
    check(np.array_equal(hist.cpu().numpy(), fastx.row_hist(bank.regs)),
          "row_hist differs from the native row histograms")
    print("  the phase 3 plan's cards (the card's histograms, the MLE "
          f"kernel, {plan.cards_host_rows} rows on the host) bit-equal to "
          "host_cards; the histograms equal to fastx.row_hist")
    h_order = hbank.sorted_by_cardinality()[:1024]
    mle_err, mle = phase_mle(
        torch, estimators, pairwise, models, hostref, synth, hist,
        torch.from_numpy(bank.regs[bank.sorted_by_cardinality()[:1024]])
        .to(dev), torch.from_numpy(hbank.aux[h_order]).to(dev),
        hbank.aux_param, dev, card)
    del hist
    fp_err = phase_band_fp_edges(torch, screened, dev)
    band_fp = band_fp_config(torch, screen, screened, dev, card)
    unpack_err, unpack = phase_unpack(torch, regpack, bank.regs, dev, card)

    print("== phase 4: selection CLI, N=2048", flush=True)
    n4 = 2048
    regs4, hll4, aux4 = synth.planted_file_banks(n4)
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
    cli_calls_hostmem(lst, ref4["smh_a"], dev, card)

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
    check(np.array_equal(cards.view(np.int64), bank.cards.view(np.int64)),
          "host_cards differs from the cards the plan set")
    # a bank with no cards yet, as a user's loader gives it: the plan
    # computes them from the card's row histograms
    fresh = models.SketchBank(names=bank.names, regs=bank.regs, p=14,
                              aux_kind="smh", aux=bank.aux, aux_param=32)
    out, launches = run_main_path(torch, screen, select_pairs, fresh, params,
                                  dev, card)
    check(fresh.has_cards() and np.array_equal(
        fresh.cards.view(np.int64), cards.view(np.int64)),
          "the main path's cards differ from host_cards")
    check(launches["screen_fused"] > 0, "main path never launched K1")
    check(launches["gate_counts"] > 0, "main path never launched the "
          "gate-count kernel")
    check(launches["row_hist"] > 0, "main path never launched the "
          "row-histogram kernel")
    check(launches["ertl_mle"] > 0, "main path never launched the MLE "
          "kernel (the plan's cards)")
    check(launches["band_fingerprints"] > 0, "main path never launched the "
          "band-fingerprint kernel")
    check_plan_fp(torch, screened, plan, bank, card,
                  "phase 3 plan (N=16384 smh_a)")
    verify_pairs(hostref, bank, [(i, i + 1) for i in picks], out, "smh_a")
    screened_out = {"smh_a": out}  # phase 9 holds the other engines to it
    device_profile(torch, lambda: select_pairs(bank, params, device=dev),
                   card, "warm select_pairs -c smh_a")

    # screen throughput over the full i<j triangle (all 136 tiles)
    spans = [(c0, min(chunk, len(tri_r) - c0))
             for c0 in range(0, len(tri_r), chunk)]
    dev_tiles = [screen.launch_tiles(tri_r[c0:c0 + w], tri_c[c0:c0 + w],
                                     True, dev) for c0, w in spans]

    def sweep():
        for tiles in dev_tiles:
            screen.screen_hits_fused(plan.d_bank, tiles, plan.d_e,
                                     plan.d_fp, **kw)

    tri_ms = cuda_ms(torch, sweep, 3)
    tri_pairs = scheduler.pair_count(
        scheduler.triangle_blocks(plan.e_s, plan.tau, 1024, False), plan.n)
    print(f"  [{card}] full-triangle screen: {len(tri_r)} tiles, "
          f"{tri_pairs} pairs in {tri_ms:.3f} ms = "
          f"{tri_pairs / tri_ms * 1e3:.6g} pairs/s")
    # the packed upload's path: the same bank and params, its lines equal
    # to the raw route's
    packed_launches, packed_16k = phase_packed(
        torch, dict(screen=screen, screened=screened,
                    SketchBank=models.SketchBank), bank, params, dev, card)
    for name in launches:
        launches[name] += packed_launches[name]

    print("== phase 6: hll main path, select_pairs hll_a / hll_an N=16384 "
          "p=14 p_aux=8", flush=True)
    for crit in ("hll_a", "hll_an"):
        out, hl = run_main_path(torch, screen, select_pairs, hbank,
                                SelectionParams(tau=0.9, criterion=crit),
                                dev, card)
        check(hl["screen_fused"] > 0 and hl["weighted_cdf_sum"] > 0
              and hl["gate_counts"] > 0 and hl["value_presence"] > 0
              and hl["row_hist"] > 0,
              f"-c {crit} never launched K1, K2, the gate-count kernel, the "
              "presence kernel and the row-histogram kernel")
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
    dense_mle = sum(phase_dense_main(torch, mods, b, pk, crit, dev, card)[
        "mle_launches"] for b, pk, crit in ((bank, picks, "smh_a"),
                                            (hbank, hpicks, "hll_a")))
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
    mods.update(mle_rows=models.bank.mle_rows,
                cards_from_hists=models.bank.cards_from_hists)
    scale, presence, rows_2g, packed_131k = phase_scale(torch, mods, dev,
                                                         card)
    print(f"  phase 11 took {time.perf_counter() - t11:.1f} s")

    print("== phase 12: the bench protocol (bench, kernel_tuning, "
          "scale_sweep)", flush=True)
    t12 = time.perf_counter()
    mods.update(synth=synth, hopper=hopper, reference_kernel=reference_kernel,
                host_cards=models.bank.host_cards)
    bench_launches, k2_p14, ref = phase_bench(torch, mods, dev, card)
    print(f"  phase 12 took {time.perf_counter() - t12:.1f} s")

    print("== phase 14: the selection CLI from sketch files with a "
          "cardinality spread (validate_cli_scale)", flush=True)
    t14 = time.perf_counter()
    cli_scale = phase_cli_scale(validate_cli_scale, screened, card)
    for name, n in cli_scale.items():
        launches[name] += n
    print(f"  phase 14 took {time.perf_counter() - t14:.1f} s")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    facts = hostmem_split.host_facts()
    print(f"hostmem: enable_arena_reuse() -> {arena}; {facts['glibc']}; THP "
          f"{facts['thp']}; {facts['cores']} host cores "
          f"({facts['cpu_model']})")
    print(card_line())
    # K1's headline numbers are the dense launch's; the gated launch's and
    # the strip variant's (with its launches in the phase 9 ring runs) ride
    # beside them; K2's are the p_aux=8 launch's, its p=14 launch (phase
    # 12) beside them. `launches` counts the main paths of phases 5 to 7
    # and 14 (phase 14's also in its own cli_scale record);
    # the phase 9 engines', phase 10's, phase 11's and phase 12's bench
    # launches stand in their own records.
    measured = {
        "screen_fused": dict(
            {key: k1["dense"][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "pack")}, max_abs_err=max_err,
            gated=k1["gated"],
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
            bench=dict(launches=bench_launches["gate_counts"])),
        "value_presence": dict(
            presence, max_abs_err=max(presence_err, presence["max_abs_err"]),
            ring=dict(launches=md["ring"]["value_presence"]),
            sharded=dict(launches=md["sharded"]["value_presence"]),
            l5=dict(launches=l5["value_presence"]),
            scale=dict(launches=scale["value_presence"]),
            bench=dict(launches=bench_launches["value_presence"])),
        "row_hist": dict(
            rows_16k, max_abs_err=max(rows_err, rows_16k["max_abs_err"],
                                      rows_2g["max_abs_err"]),
            scale=dict(rows_2g, launches=scale["row_hist"]),
            ring=dict(launches=md["ring"]["row_hist"]),
            sharded=dict(launches=md["sharded"]["row_hist"]),
            l5=dict(launches=l5["row_hist"]),
            bench=dict(launches=bench_launches["row_hist"])),
        "ertl_mle": dict(
            mle, max_abs_err=mle_err,
            dense=dict(launches=dense_mle),
            ring=dict(launches=md["ring"]["ertl_mle"]),
            sharded=dict(launches=md["sharded"]["ertl_mle"]),
            l5=dict(launches=l5["ertl_mle"]),
            scale=dict(launches=scale["ertl_mle"]),
            bench=dict(launches=bench_launches["ertl_mle"])),
        "band_fingerprints": dict(
            band_fp, max_abs_err=max(fp_err, band_fp["max_abs_err"]),
            ring=dict(launches=md["ring"]["band_fingerprints"]),
            sharded=dict(launches=md["sharded"]["band_fingerprints"]),
            l5=dict(launches=l5["band_fingerprints"]),
            scale=dict(launches=scale["band_fingerprints"]),
            bench=dict(launches=bench_launches["band_fingerprints"])),
        "regpack_unpack": dict(
            unpack, max_abs_err=unpack_err, uploads=packed_16k,
            ring=dict(launches=md["ring"]["regpack_unpack"]),
            sharded=dict(launches=md["sharded"]["regpack_unpack"]),
            l5=dict(launches=l5["regpack_unpack"]),
            scale=dict(packed_131k, launches=scale["regpack_unpack"]),
            bench=dict(launches=bench_launches["regpack_unpack"]))}
    for name, n in cli_scale.items():
        measured[name]["cli_scale"] = dict(launches=n)
    # the reference's own kernel: a measured baseline, not a port of a
    # TPU kernel; its launches are phase 12's rates run
    ref_record = dict(
        name="reference_cbsmh", route="cuda", role="baseline (experiment)",
        route_detail="the reference's kernel_CBsmh with hll_union_card as "
        "the reference wrote it: one thread a pair, the smh_a gate, byte "
        "loads, f64 ORIGINAL union, atomicAdd append",
        source=f"{PKG}/experiments/reference_kernel.cu",
        replaces="none: the reference's GPU kernel "
        "(src/selection_kernels.cu:63-117), not a TPU kernel", **ref)
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", route_detail=detail, source=src,
        replaces=replaces, launches=launches[name], **measured[name])
        for name, (src, replaces, detail) in KERNELS.items()]
        + [ref_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
