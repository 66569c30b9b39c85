"""Where the time of the row-histogram kernel (csrc/row_hist.cu) goes, at
the shapes its callers give it: the kernel as it is, the mask-walk design
it replaced, the other counter layouts and updates tried for it, and the
loads alone and its end-of-row sums apart.

    python3 -m cuda_selection_criteria_tpu_torch.experiments.hist_split \
        [--seed 0] [--reps 10] [--cell smh_a-524k] [--no-bench-2g] \
        [--sass-out FILE]

Needs one CUDA card. Builds experiments/hist_split.cu (which includes the
kernel's source) with nvcc into the package's build directory, prints
ptxas's registers, shared memory and spills a variant, the CTAs an SM each
variant holds, and, from cuobjdump, the SASS instructions of each
variant's row loop per byte (--sass-out keeps the whole listing); then,
for each shape, one line of every variant's milliseconds a launch in two
turns (CUDA events over --reps launches issued back to back by the
library, so no Python between them; the second turn in the reverse
order), the wrapper's (screen.row_hist, with its 32-byte read-back), and
one JSON line. The shapes: 2^17 rows of real-sized genomes' registers at
p=14 (utils/synth.genome_regs, drawn on the card: no zero byte, 2 GiB),
2^17 rows whose 16,384 bytes all hold one value (every count of a lane on
one counter), the N=16384 bench bank (2048 hashes a genome: 88% of the
bytes are 0), the first 16,384 dense rows (256 MiB, beside one
torch.bincount of row * 64 + reg, the library yardstick), the planted
bench bank at N=131,072 (validate_131k_scale.make_bank, 2 GiB, made on
the host; not with --no-bench-2g) and, with --cell, that benchmark cell's
own bank (benchmark/bank.py from --seed). Exits 1 unless every variant
that computes the histograms gives the plain version's histograms and
present values on every shape.

Variants (csrc/row_hist.cu's head says why the kernel is built as it is):
  kernel      csc_row_hist as the wrapper launches it: every byte, zeros
              included, taken by one __byte_perm and counted by one
              red.shared.add on the lane's 32-bit value-major counter
              (8 KiB a warp, four warps a CTA), counters never cleared
  maskwalk    the design it replaced, as it launched: a mask of each
              vector's non-zero bytes walked with __ffs, each byte a shared
              load, add and store on a 16-bit half, eight warps a CTA
  line16      straight-line bytes on the same 16-bit halves, zeros
              skipped, a shared load, add and store each
  red16       the same halves, a shared reduction (1 or 1 << 16) each
  line32      straight-line bytes on the kernel's 32-bit counters, zeros
              skipped, a shared load, add and store each
  line32_all  line32 counting the zeros too
  red32       the kernel with the zeros skipped (bin 0 from R less the
              counted bytes)
  red32_lop3  red32 with each byte taken by a LOP3 mask that also tests it
              and its counter's address by a shift of the masked word
  no_reduce   the kernel without its end-of-row sums (a probe: its bins
              are not the histograms)
  loads       the kernel's loads alone: every byte read, a word a lane
              written where its bins go
The bound is chip_smoke.py's: the bytes read once and the histograms (and
the 32-byte mask) written once at HBM_BYTES_PER_S.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import _build, screen
from ..utils import hopper, hostmem, synth
from .mle_split import _ms, card_line, ptxas_lines

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "hist_split.cu")
VARIANTS = {"kernel": 0, "maskwalk": 1, "line16": 2, "red16": 3,
            "line32": 4, "line32_all": 5, "red32": 6, "red32_lop3": 7,
            "no_reduce": 8, "loads": 9}
# the variants that compute the histograms
COMPUTING = tuple(v for v in VARIANTS if v not in ("no_reduce", "loads"))
# each variant's kernel in the SASS listing, and the bytes a lane counts in
# one pass of its row loop (kU = 4 vectors of 16 bytes)
SASS_NAMES = {v: "row_hist_kernel" if v == "kernel" else f"hs_{v}"
              for v in VARIANTS}
LOOP_BYTES = 64
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b(?:\.\S+)?\s+(?:`?\(?)(0x[0-9a-f]+)")
_SHARED = re.compile(r"\b(ATOMS|REDS?|LDS|STS)\b")


def build():
    """(library path, build seconds, nvcc log) of hist_split.cu, built into
    the package's build directory under a name hashed from it and the
    kernel's source; seconds 0.0 and an empty log where it existed."""
    return _build.build_probe(SOURCE, "row_hist", "hist_split")


def load(path):
    lib = ctypes.CDLL(path)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hist_split_run.argtypes = [I, P, LL, I, P, P, I, P]
    lib.hist_split_run.restype = I
    lib.hist_split_occupancy.argtypes = [I]
    lib.hist_split_occupancy.restype = I
    return lib


def occupancy(lib):
    """{variant: CTAs an SM} as the runtime computes them."""
    return {v: lib.hist_split_occupancy(i) for v, i in VARIANTS.items()}


def _functions(sass):
    """{function name: [(address, instruction text)]} of a cuobjdump -sass
    listing."""
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _LINE.search(ln)
        if m and cur is not None:
            out_text = m.group(2).strip()
            cur.append((int(m.group(1), 16), out_text))
    return out


def _loops(code):
    """[(start, end)] address ranges of the backward branches in code."""
    loops = []
    for addr, text in code:
        m = _BRA.search(text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    return loops


def loop_range(code, mem="LDG"):
    """(start, end) addresses of the innermost backward-branch range of
    code that holds an instruction matching the regex `mem` (a global
    load by default), or None where there is none."""
    pat = re.compile(mem)
    found = [(lo, hi) for lo, hi in _loops(code)
             if any(pat.search(t) for a, t in code if lo <= a <= hi)]
    return min(found, key=lambda r: r[1] - r[0]) if found else None


def loop_counts(code):
    """The row loop of one kernel's SASS: the innermost backward-branch
    range that holds a global load (LDG). Returns {"loop": its
    instructions, "shared": its shared-memory instructions, "per_byte":
    instructions per byte counted, "inner": the length of the loops nested
    in it (the mask walk's per-byte loop), or None where no such range}.
    A straight-line loop counts LOOP_BYTES bytes a pass; a loop with an
    inner loop costs the inner loop's length per non-zero byte."""
    loops = _loops(code)

    def body(lo, hi):
        return [t for a, t in code if lo <= a <= hi]

    found = loop_range(code)
    if found is None:
        return None
    lo, hi = found
    inner = sorted(len(body(a, b)) for a, b in loops
                   if lo <= a and b <= hi and (a, b) != (lo, hi))
    n = len(body(lo, hi))
    shared = sum(1 for t in body(lo, hi) if _SHARED.search(t))
    per_byte = (inner[len(inner) // 2] if inner else n / LOOP_BYTES)
    return dict(loop=n, shared=shared, inner=inner or None,
                per_byte=per_byte)


def sass_listing(path, keep=None):
    """cuobjdump -sass's listing of the library at path, or None where
    cuobjdump is not installed; with keep, the listing is written there
    too."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300).stdout
    if keep:
        os.makedirs(os.path.dirname(os.path.abspath(keep)), exist_ok=True)
        with open(keep, "w") as fh:
            fh.write(sass)
    return sass


def sass_counts(path, keep=None):
    """{variant: loop_counts of its kernel} from cuobjdump's listing of the
    library (None where cuobjdump is not installed or a kernel is not
    found); with keep, the whole listing is written there."""
    sass = sass_listing(path, keep)
    if sass is None:
        return None
    funcs = _functions(sass)
    out = {}
    for v, name in SASS_NAMES.items():
        code = next((c for f, c in funcs.items() if name in f), None)
        out[v] = None if code is None else loop_counts(code)
    return out


def _launcher(lib, variant, regs, hist, mask):
    """fn(reps) that launches `variant` reps times over the 2-D regs."""
    stream = torch.cuda.current_stream().cuda_stream
    n, r = regs.shape

    def fn(reps):
        err = lib.hist_split_run(VARIANTS[variant], regs.data_ptr(), n, r,
                                 hist.data_ptr(), mask.data_ptr(), reps,
                                 stream)
        if err != 0:
            raise RuntimeError(f"hist_split {variant}: cudaError_t {err}")
    return fn


def shape_record(lib, label, regs, card, reps=10, library=False,
                 out=print):
    """The variants on one card bank regs (2-D uint8, contiguous): the
    histograms and present values of every variant that computes them
    checked against the plain version, then each variant timed in two
    turns (the second in the reverse order) and the wrapper once between
    them; with library, one torch.bincount of row * 64 + reg (its int64
    index, cast and add timed with it) checked and timed too. Returns the
    JSON record."""
    n, r = regs.shape
    dev = regs.device
    want, want_vals = screen._row_hist_plain(regs, 2048)
    hist = torch.empty((n, 64), dtype=torch.int32, device=dev)
    mask = torch.zeros(8, dtype=torch.int32, device=dev)
    equal = {}
    for v in COMPUTING:
        hist.fill_(-1)
        mask.zero_()
        _launcher(lib, v, regs, hist, mask)(1)
        torch.cuda.synchronize()
        words = mask.cpu().numpy()
        equal[v] = bool(torch.equal(hist, want) and not words[2:].any()
                        and screen.mask_values(words) == want_vals)
    zeros = int(want[:, 0].sum())
    del want
    ms = {v: _ms(torch, _launcher(lib, v, regs, hist, mask), reps)
          for v in VARIANTS}
    wrapper_ms = _ms(torch, lambda k: [screen.row_hist(regs)
                                       for _ in range(k)], reps)
    ms2 = {v: _ms(torch, _launcher(lib, v, regs, hist, mask), reps)
           for v in reversed(VARIANTS)}
    library_ms = None
    if library:
        offs = torch.arange(n, device=dev, dtype=torch.int64)[:, None] * 64

        def bincount(k=1):
            for _ in range(k):
                got = torch.bincount((regs.to(torch.int64) + offs).view(-1),
                                     minlength=n * 64)
            return got

        got, _ = screen.row_hist(regs)
        equal["library"] = bool(torch.equal(bincount().view(n, 64).to(
            torch.int32), got))
        library_ms = _ms(torch, bincount, 2)
    nbytes = n * r + n * 256 + 32
    bound_ms = nbytes / hopper.HBM_BYTES_PER_S * 1e3
    share = {v: bound_ms / min(ms[v], ms2[v]) for v in VARIANTS}
    rec = dict(shape=label, rows=n, row_bytes=r, card=card,
               zero_registers=zeros, zero_share=zeros / (n * r),
               equal=equal, ms=ms, ms2=ms2, wrapper_ms=wrapper_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes",
               bytes=nbytes, share=share)
    lib_txt = ("" if library_ms is None else
               f"; library (one torch.bincount of row * 64 + reg) "
               f"{library_ms:.3f} ms")
    out(f"  [{card}] hist_split {label} ({n} x {r} bytes, "
        f"{rec['zero_share']:.3f} of them 0): "
        + ", ".join(f"{v} {ms[v]:.4f} / {ms2[v]:.4f}" for v in VARIANTS)
        + f" ms (two turns, the launch alone); wrapper {wrapper_ms:.4f} ms "
        f"(with the 32-byte read-back); bound {bound_ms:.4f} ms (bytes), "
        f"kernel share {share['kernel']:.3f}{lib_txt}; bit-equal to plain: "
        f"{equal}", flush=True)
    return rec


def dense_rows(seed, dev, n=1 << 17, p=14):
    """n rows of real-sized genomes' registers at p, drawn on the card."""
    return synth.genome_regs(torch, n, p, seed, dev)


def one_value_rows(dev, n=1 << 17, p=14, value=9):
    """n rows of 2^p bytes that all hold `value`."""
    return torch.full((n, 1 << p), value, dtype=torch.uint8, device=dev)


def bench_16k(seed):
    """The N=16384 bench bank's registers (2048 hashes a genome at p=14),
    host numpy."""
    regs, _ = synth.synthetic_hll_banks(16384, 2048, (14, 8),
                                        np.random.default_rng(seed))
    return regs


def shapes(dev, seed, bench_2g=True, cell=None, regs_16k=None, out=print):
    """Yields (label, card bank, library) one shape at a time, so that the
    caller frees each before the next is made; regs_16k (host) stands for
    the N=16384 bench bank where given."""
    t0 = time.perf_counter()
    dense = dense_rows(seed, dev)
    torch.cuda.synchronize()
    out(f"  dense rows made on the card in {time.perf_counter() - t0:.1f} s")
    yield "2^17 real-genome rows p=14 (2 GiB)", dense, False
    yield "16,384 real-genome rows p=14", dense[:16384], True
    del dense
    torch.cuda.empty_cache()
    yield "2^17 rows of one value p=14", one_value_rows(dev), False
    torch.cuda.empty_cache()
    regs = bench_16k(seed) if regs_16k is None else regs_16k
    yield "N=16384 bench bank", torch.from_numpy(regs).to(dev), True
    if bench_2g:
        from . import validate_131k_scale
        bank, _, secs = validate_131k_scale.make_bank(1 << 17)
        out(f"  N=131072 bench bank made in {secs:.1f} s (host)")
        d = torch.from_numpy(bank.regs).to(dev)
        del bank
        yield "N=131072 bench bank (2 GiB)", d, False
        del d
        torch.cuda.empty_cache()
    if cell:
        from benchmark import bank as bank_mod
        from benchmark.run import load_cells
        spec = load_cells()[cell]
        t0 = time.perf_counter()
        cregs = bank_mod.make_bank(spec.n, spec.aux_kind, spec.aux_param,
                                   spec.planted, seed).regs
        d = torch.from_numpy(cregs).to(dev)
        del cregs
        out(f"  {cell} bank made in {time.perf_counter() - t0:.1f} s")
        yield f"{cell}'s own bank", d, False
        del d
        torch.cuda.empty_cache()


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cell", default=None,
                    help="also this benchmark cell's own bank")
    ap.add_argument("--no-bench-2g", action="store_true",
                    help="leave out the N=131072 bench bank")
    ap.add_argument("--sass-out", default=None,
                    help="write the library's whole SASS listing here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hist_split: needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    path, secs, log = build()
    print(f"built {os.path.basename(path)} in {secs:.2f} s")
    for ln in ptxas_lines(log):
        print(f"  ptxas {ln}")
    lib = load(path)
    print(f"  CTAs an SM: {json.dumps(occupancy(lib))}")
    print(f"  SASS of each row loop: "
          f"{json.dumps(sass_counts(path, args.sass_out))}")
    dev = torch.device("cuda")
    ok = True
    for label, regs, library in shapes(dev, args.seed,
                                       not args.no_bench_2g, args.cell):
        rec = shape_record(lib, label, regs, card, args.reps, library)
        print(json.dumps(rec), flush=True)
        ok &= all(rec["equal"].values())
        del regs
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
