"""Where the time of the ERTL-MLE kernel (csrc/ertl_mle.cu) goes, at the
shapes its callers give it: the kernel as it is, the serial-staging design
it replaced (one thread a row in 128-row CTAs, each bin staged by a load
that the next copy waited on), each design's staging alone and loop
alone, the other layouts tried for the kernel, and the kernel on
identical rows and on the same rows sorted by their step count (the cost
of divergent secant loops within a warp). The row histograms'
counterpart is experiments/hist_split.py.

    python3 -m cuda_selection_criteria_tpu_torch.experiments.mle_split \
        [--seed 0] [--reps 20] [--cell smh_a-524k] [--clock-probe]

Needs one CUDA card. Builds experiments/mle_split.cu (which includes the
kernel's source) with nvcc into the package's build directory, prints
ptxas's registers, shared memory and spills a variant and the FP64 / FP32
instructions of one __ddiv_rn / __fdiv_rn in the SASS (cuobjdump), then,
for each shape, one line of every variant's milliseconds a launch (CUDA
events over --reps launches issued back to back by the library, so no
Python between them) and one JSON line. The shapes: the plan's cards call
(f64 with flags) on the row histograms of a 16,384-genome bench bank (2048
hashes a genome) and on those histograms 32 times (524,288 rows), on
524,288 rows of real-sized genomes (utils/synth.genome_hists: cardinality
log-uniform in [2^20, 2^24], no zero register) and, with --cell, on that
benchmark cell's own bank (benchmark/bank.py from --seed, its row
histograms on the card); the dense engine's calls on one 512 x 512 tile's
union histograms at p=14 (f32 and f64) and of aux HLLs at p_aux=8 (f32).
--clock-probe first runs kernel, loop, stage and w1b2_indep for a second
each on the real-genome rows while nvidia-smi samples the SM clock and
the power draw. Exits 1 unless every variant that computes the estimates
gives the plain version's bits and flags on every shape.

Variants:
  kernel        csc_ertl_mle as the wrapper launches it
  serial        the serial-staging design, with the kernel's per-row loop
  serial_stage  its staging alone (a checksum of each staged row written)
  serial_loop   its loop alone, every row the shape's median row, filled
                from one row that all threads read at one address
  stage         the kernel's persistent groups and copies alone (checksum)
  loop          the kernel's persistent groups and loop alone (rows as in
                serial_loop)
  w1b2          one-warp CTAs, two groups a warp: the next group's copies
                in flight while the current group's loop runs (16 warps
                an SM); w1b2_stage and w1b2_loop its parts alone;
                w1b2_indep both at once but independent (the copies land
                in one buffer while the loop runs on the median row in the
                other)
  w2b1_pf       the kernel with one bulk L2 prefetch of the warp's next
                group before each loop
  ws8           warp-specialized: a producer warp a CTA fills a ring of
                groups (mbarriers) for 8 consumer warps
  identical     the kernel on n copies of the median row
  sorted_steps  the kernel on the rows sorted by their inner updates a
                secant step (h_hi - kMinP + 1), then by their estimate
The bound is chip_smoke.py's: the larger of the work counter's operations
at the FP64 (FP32) rate and the q + 2 bins of each row read once with the
outputs written once at HBM_BYTES_PER_S; beside it, for information, the
operations with each division counted at its SASS instructions.
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

from ..ops import _build, estimators, pairwise, screen
from ..utils import hopper, hostmem, synth

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "mle_split.cu")
VARIANTS = {"kernel": 0, "serial": 1, "serial_stage": 2, "serial_loop": 3,
            "stage": 4, "loop": 5, "w1b2": 6, "w1b2_stage": 7,
            "w1b2_loop": 8, "w1b2_indep": 9, "w2b1_pf": 10, "ws8": 11}
# the variants that compute the estimates
COMPUTING = ("kernel", "serial", "w1b2", "w2b1_pf", "ws8")
_IN_KIND = {torch.int32: 0, torch.float32: 2}
# SASS opcodes of the FP64 and FP32 pipes in a division's fast path
_FP_OPS = {"f64": re.compile(r"\b(DFMA|DMUL|DADD|DSETP|MUFU\.RCP64H)\b"),
           "f32": re.compile(r"\b(FFMA|FMUL|FADD|FSETP|FCHK|MUFU\.RCP)\b")}


def build():
    """(library path, build seconds, nvcc log) of mle_split.cu, built into
    the package's build directory under a name hashed from it and the
    kernel's source; seconds 0.0 and an empty log where it existed."""
    return _build.build_probe(SOURCE, "ertl_mle", "mle_split")


def load(path):
    lib = ctypes.CDLL(path)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mle_split_run.argtypes = [I, P, I, LL, LL, I, I, ctypes.c_double,
                                  P, P, P, I, P]
    lib.mle_split_run.restype = I
    return lib


def ptxas_lines(log):
    """ptxas's registers, shared memory, stack and spills, one line a
    kernel, with its name."""
    out, name, props = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, props = m.group(1), ""
        elif "spill" in ln or "stack frame" in ln:
            props = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {props}")
    return out


def div_instructions(path):
    """{"f64": n, "f32": n}: the FP64 and FP32 instructions of one
    __ddiv_rn / __fdiv_rn (the probes mle_split_div_f64 / _f32) in the
    SASS up to the first EXIT (the fast path; the slow path's call lies
    after it), or None where cuobjdump is not installed."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300).stdout
    out = {}
    for key, pat in _FP_OPS.items():
        body = sass.split(f"Function : mle_split_div_{key}", 1)
        if len(body) < 2:
            return None
        fast = body[1].split("EXIT", 1)[0]
        out[key] = len(pat.findall(fast))
    return out


def _ms(torch, fn, reps):
    fn(1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(reps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _launcher(lib, variant, rows, p, dtype, est, flags, row):
    """fn(reps) that launches `variant` reps times over the 2-D rows."""
    f64 = int(dtype == torch.float64)
    eps = estimators._secant_eps(1e-2, p, dtype)
    stream = torch.cuda.current_stream().cuda_stream

    def fn(reps):
        err = lib.mle_split_run(
            VARIANTS[variant], rows.data_ptr(), _IN_KIND[rows.dtype],
            rows.shape[0], rows.stride(0), p, f64, eps, est.data_ptr(),
            0 if flags is None else flags.data_ptr(), row.data_ptr(), reps,
            stream)
        if err != 0:
            raise RuntimeError(f"mle_split {variant}: cudaError_t {err}")
    return fn


def shape_record(lib, label, counts, p, dtype, branch, card, divs,
                 reps=20, out=print):
    """The variants on one shape: the estimates and flags of every
    variant that computes them checked against the plain version, then
    each variant timed. Returns the JSON record."""
    n = counts.shape[:-1].numel()
    rows = counts.reshape(n, counts.shape[-1])
    work = {}
    want = estimators._ertl_mle_plain(rows, p, dtype=dtype, work=work)
    bound = work_bound(rows, p, dtype, branch, work, divs)
    want_flags = estimators.log1p_branch(rows, p, dtype)
    est = torch.empty(n, dtype=dtype, device=rows.device)
    flags = (torch.empty(n, dtype=torch.bool, device=rows.device) if branch
             else None)
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    order = torch.argsort(want, stable=True)
    mid = int(order[n // 2])
    row = torch.zeros(64, dtype=torch.float32, device=rows.device)
    row[:66 - p] = rows[mid, :66 - p].float()
    equal = {}
    for v in COMPUTING:
        est.fill_(-1)
        _launcher(lib, v, rows, p, dtype, est, flags, row)(1)
        torch.cuda.synchronize()
        equal[v] = bool(torch.equal(est.view(bits), want.view(bits))
                        and (flags is None or torch.equal(flags, want_flags)))
    ms = {v: _ms(torch, _launcher(lib, v, rows, p, dtype, est, flags, row),
                 reps) for v in VARIANTS}
    same = rows[mid:mid + 1].expand(n, rows.shape[1]).contiguous()
    ms["identical"] = _ms(torch, _launcher(lib, "kernel", same, p, dtype,
                                           est, flags, row), reps)
    del same
    # rows of like step count together: the inner updates a secant step
    # (h_hi - kMinP + 1 from the final estimate's exponent), then the
    # estimate
    q = 64 - p
    nz = rows[:, :q + 2] > 0
    ks = torch.arange(q + 2, device=rows.device)
    k_min = torch.where(nz, ks, q + 2).amin(1).clamp(1, q)
    k_max = torch.where(nz, ks, -1).amax(1).clamp(0, q)
    x = (want / (1 << p)).clamp(min=1e-300).nan_to_num(1.0, 1.0, 1.0)
    kappa = torch.floor(torch.log2(x)).to(torch.int64) + 1
    key = (torch.maximum(kappa, k_max - 1) - k_min).clamp(-1, 64) + 1
    order2 = torch.argsort(key.double() * 4.0 + order.argsort().double()
                           / n, stable=True)
    by_steps = rows[order2].contiguous()
    ms["sorted_steps"] = _ms(torch, _launcher(lib, "kernel", by_steps, p,
                                              dtype, est, flags, row), reps)
    del by_steps
    ms["kernel_again"] = _ms(torch, _launcher(lib, "kernel", rows, p, dtype,
                                              est, flags, row), reps)
    bound_ms = bound["bound_ms"]
    rec = dict(shape=label, rows=n, p=p, dtype=str(dtype)[6:],
               in_dtype=str(rows.dtype)[6:], row_stride=rows.stride(0),
               flags=branch, card=card, equal=equal, ms=ms, **bound,
               share={v: bound_ms / t for v, t in ms.items()})
    out(f"  [{card}] mle_split {label} ({n} rows, p={p}, "
        f"{rec['in_dtype']} in, {rec['dtype']}"
        f"{', flags' if branch else ''}; {work['secant_steps']} secant "
        f"steps, {work['update_steps']} inner updates): "
        + ", ".join(f"{v} {t:.4f}" for v, t in ms.items())
        + f" ms; bound {bound_ms:.4f} ms ({rec['bound_by']}; bytes "
        f"{rec['bytes_ms']:.4f}, operations {rec['ops_ms']:.4f}"
        + ("" if rec["ops_div"] is None else
           f", with each division at its {rec['div_instructions']} SASS "
           f"instructions {rec['ops_div_ms']:.4f}")
        + f" ms); kernel share {bound_ms / ms['kernel']:.3f}; bit-equal to "
        f"plain: {equal}")
    return rec


def work_bound(rows, p, dtype, branch, work=None, divs=None):
    """The bound of the MLE over the (n, >= q + 2) histograms `rows`: the
    larger of the operations these rows' loops need (the plain version's
    work counter; `work` if it has run already) at the card's FP64 or FP32
    rate outside the tensor cores and the q + 2 bins of each row read once
    with the estimates (and with branch the flags) written once at
    HBM_BYTES_PER_S; beside it, with `divs` (div_instructions), the
    operations with each division at its SASS instructions."""
    if work is None:
        work = {}
        estimators._ertl_mle_plain(rows, p, dtype=dtype, work=work)
    n = rows.shape[0]
    f64 = dtype == torch.float64
    rate = hopper.FP64_OPS_PER_S if f64 else hopper.FP32_OPS_PER_S
    nbytes = (n * (66 - p) * rows.element_size() + n * (8 if f64 else 4)
              + (n if branch else 0))
    bytes_ms = nbytes / hopper.HBM_BYTES_PER_S * 1e3
    ops_ms = work["ops"] / rate * 1e3
    n_div = work["rows"] + 3 * work["secant_steps"] + work["update_steps"]
    per_div = None if divs is None else divs["f64" if f64 else "f32"]
    ops_div = None if per_div is None else work["ops"] + n_div * (per_div - 1)
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, bytes_ms=bytes_ms, ops=work["ops"],
                ops_ms=ops_ms, divisions=n_div, div_instructions=per_div,
                ops_div=ops_div,
                ops_div_ms=None if ops_div is None else ops_div / rate * 1e3,
                secant_steps=work["secant_steps"],
                update_steps=work["update_steps"])


def default_shapes(dev, seed, cell=None, out=print):
    """[(label, counts, p, dtype, branch)] of the shapes in the module
    docstring, made from seed."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    regs, aux = synth.synthetic_hll_banks(16384, 2048, (14, 8), rng)
    d = torch.from_numpy(regs).to(dev)
    hist, _ = screen.row_hist(d)
    a = torch.from_numpy(aux).to(dev)
    genomes = torch.from_numpy(synth.genome_hists(1 << 19, 14, rng)).to(dev)
    out(f"  mle_split shapes made in {time.perf_counter() - t0:.1f} s "
        f"(host)")
    unions = pairwise.union_histograms(d[:512], d[512:1024], 14)
    shapes = [
        ("cards 524,288 rows (the 16k bank's histograms 32 times)",
         hist.repeat(32, 1), 14, torch.float64, True),
        ("cards N=16384 bench bank", hist, 14, torch.float64, True),
        ("cards 524,288 real-genome rows", genomes, 14, torch.float64, True),
        ("512 x 512 tile unions f32", unions, 14, torch.float32, False),
        ("512 x 512 tile unions f64", unions, 14, torch.float64, False),
        ("512 x 512 tile aux unions p_aux=8 f32",
         pairwise.union_histograms(a[:512], a[512:1024], 8), 8,
         torch.float32, False)]
    if cell:
        from benchmark import bank as bank_mod
        from benchmark.run import load_cells
        spec = load_cells()[cell]
        t0 = time.perf_counter()
        cregs = bank_mod.make_bank(spec.n, spec.aux_kind, spec.aux_param,
                                   spec.planted, seed).regs
        dc = torch.from_numpy(cregs).to(dev)
        del cregs
        chist, _ = screen.row_hist(dc)
        del dc
        torch.cuda.empty_cache()
        out(f"  {cell} bank made in {time.perf_counter() - t0:.1f} s")
        shapes.insert(1, (f"cards {cell}'s own bank", chist, 14,
                          torch.float64, True))
    return shapes


def clock_probe(lib, rows, p, dtype, branch, row, secs=1.0):
    """Each of kernel, loop, stage and w1b2_indep launched back to back for
    about `secs` while nvidia-smi samples the SM clock and the power draw
    every 20 ms: {variant: (median MHz, median W, samples)}."""
    n = rows.shape[0]
    est = torch.empty(n, dtype=dtype, device=rows.device)
    flags = (torch.empty(n, dtype=torch.bool, device=rows.device) if branch
             else None)
    out = {}
    for v in ("kernel", "loop", "stage", "w1b2_indep"):
        fn = _launcher(lib, v, rows, p, dtype, est, flags, row)
        reps = max(1, int(secs / (_ms(torch, fn, 20) * 1e-3)))
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, text=True)
        time.sleep(0.3)
        fn(reps)
        torch.cuda.synchronize()
        smi.terminate()
        lines = smi.communicate()[0].strip().splitlines()
        vals = np.array([[float(x) for x in ln.split(",")] for ln in lines
                         if ln.strip()])
        busy = vals[15:-3] if len(vals) > 20 else vals
        out[v] = (float(np.median(busy[:, 0])), float(np.median(busy[:, 1])),
                  len(busy))
    return out


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cell", default=None,
                    help="also the cards call on this benchmark cell's bank")
    ap.add_argument("--clock-probe", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mle_split: needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    path, secs, log = build()
    print(f"built {os.path.basename(path)} in {secs:.2f} s")
    for ln in ptxas_lines(log):
        print(f"  ptxas {ln}")
    divs = div_instructions(path)
    print(f"  SASS instructions a division (fast path): {divs}")
    lib = load(path)
    dev = torch.device("cuda")
    ok = True
    if args.clock_probe:
        h = synth.genome_hists(1 << 19, 14, np.random.default_rng(args.seed))
        d = torch.from_numpy(h).to(dev)
        row = torch.zeros(64, dtype=torch.float32, device=dev)
        row[:52] = d[0, :52].float()
        print(f"  clock probe (MHz, W, samples): "
              f"{clock_probe(lib, d, 14, torch.float64, True, row)}")
    for label, counts, p, dtype, branch in default_shapes(
            dev, args.seed, args.cell):
        rec = shape_record(lib, label, counts, p, dtype, branch, card, divs,
                           args.reps)
        print(json.dumps(rec), flush=True)
        ok &= all(rec["equal"].values())
        del counts
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
