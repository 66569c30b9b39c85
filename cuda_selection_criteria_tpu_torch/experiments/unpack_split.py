"""Where the time of the bit-plane unpack kernel (csrc/regpack_unpack.cu)
goes, on the packed upload's 128 MiB slabs: the kernel as the wrapper
launches it (its word path), its byte path on the same slab, the
design it replaced, both paths at other CTA sizes and grids, and the
word path's loads and stores alone and its arithmetic alone.

    python3 -m cuda_selection_criteria_tpu_torch.experiments.unpack_split \
        [--seed 0] [--reps 20] [--sass-out FILE]

Needs one CUDA card. Builds experiments/unpack_split.cu (which includes the
kernel's source) with nvcc into the package's build directory, prints
ptxas's registers, shared memory and spills a variant, the CTAs an SM each
variant holds and, from cuobjdump, each variant's loop at k = 5 and k = 6:
its SASS instructions and integer instructions a register (--sass-out
keeps the whole listing); then, for each slab, one line of every
variant's milliseconds a launch in two turns (CUDA events over --reps
launches issued back to back by the library, so no Python between them;
the second turn in the reverse order), the wrapper's (regpack.unpack_rows),
a device-to-device copy that moves as many bytes (the card's streaming
rate, a yardstick), and one JSON line. The slabs are chip_smoke.py's: the
first 8192 rows of the N=16384 bench bank (2048 hashes a genome at p=14,
k = 5) and 8192 rows of 2^14 registers over 33 values scattered over
0..63 (k = 6), each packed on the host with its own alphabet. Exits 1
unless every variant that computes the rows gives the plain version's on
both slabs.

Variants (csrc/regpack_unpack.cu's head says why the kernel is built as
it is):
  kernel     csc_regpack_unpack as the wrapper launches it: the word
             path, 256 threads a CTA, one group (32 registers) a thread
  byte       the byte path (unpack_bytes_kernel) on the same slab, as the
             kernel launches it: 16 CTAs an SM, a grid-stride loop
  replaced   the design it replaced: one thread a byte of every plane, k
             at run time, 64-bit index words, 16 CTAs an SM
  memory     the word path's loads and stores alone (the plane words
             stored as they are), one group a thread
  arith      the word path's arithmetic alone, over the resident CTAs:
             the planes taken from registers and fed back from each
             decode, no load or store in the loop
  t128       the word path at 128 threads a CTA
  t512       the word path at 512 threads a CTA
  resident   the word path's grid-stride loop over the CTAs that stay
             resident (one wave)
  ctas4      the same loop over 4 CTAs an SM
  byte_flat  the byte path, one group (8 registers) a thread
  memory_resident  memory over its resident CTAs
The bound is chip_smoke.py's: the larger of the planes read once and the
registers written once at HBM_BYTES_PER_S and k + 1 integer operations a
register at INT32_OPS_PER_S.
"""

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

from ..ops import _build, regpack
from ..utils import hopper, hostmem
from . import hist_split
from .mle_split import _ms, card_line, ptxas_lines

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "unpack_split.cu")
VARIANTS = {"kernel": 0, "byte": 1, "replaced": 2, "memory": 3, "arith": 4,
            "t128": 5, "t512": 6, "resident": 7, "ctas4": 8,
            "byte_flat": 9, "memory_resident": 10}
# the variants that compute the rows
COMPUTING = tuple(v for v in VARIANTS
                  if v not in ("memory", "arith", "memory_resident"))
SLAB_ROWS = 8192
# integer-pipe opcodes of a loop (the rest: loads, stores, branches)
_INT_OPS = {"LOP3", "LOP", "SHF", "PRMT", "IADD3", "IADD", "IMAD", "ISETP",
            "LEA", "SEL", "IMNMX", "VIADD", "VIMNMX", "IMUL", "BMSK",
            "SGXT", "FLO", "POPC", "IABS", "BREV", "MOV", "UIADD3", "ULOP3",
            "USHF", "UMOV", "ULEA", "UIMAD", "UISETP", "USEL"}


def bound(ops_secs, bytes_secs):
    """(bound_ms, bound_by): the larger of the two times."""
    return (max(ops_secs, bytes_secs) * 1e3,
            "operations" if ops_secs >= bytes_secs else "bytes")


def sass_names(k):
    """{variant: (substrings of its kernel's mangled name at k), registers
    a pass of its loop decodes, the regex of an instruction its loop holds
    that no loop of the set-up does}; the variants that launch the kernel
    of another share its SASS."""
    word = ("unpack_words_kernel", f"ILi{k}ELi256E")
    return {"kernel": (word, 32, "LDS"),
            "byte": (("unpack_bytes_kernel", f"ILi{k}E"), 8, "LDS"),
            "replaced": (("replaced_unpack_kernel",), 8, "LDS"),
            "memory": (("us_memory_kernel", f"ILi{k}E"), 32, "LDG"),
            "arith": (("us_arith_kernel", f"ILi{k}E"), 32, "LDS"),
            "t128": (("unpack_words_kernel", f"ILi{k}ELi128E"), 32, "LDS"),
            "t512": (("unpack_words_kernel", f"ILi{k}ELi512E"), 32, "LDS")}


def opcode(text):
    """The opcode of one SASS instruction, without its predicate and
    modifiers ("@!P1 LDG.E.EF.128 R4, ..." -> "LDG")."""
    tokens = text.split()
    if tokens and tokens[0].startswith("@"):
        tokens = tokens[1:]
    return tokens[0].split(".")[0] if tokens else ""


def loop_record(code, regs, mem):
    """The main loop of one kernel's SASS (hist_split.loop_range: the
    innermost backward-branch range holding an instruction that matches
    mem): its instructions and integer instructions as laid out, their
    counts a register (regs decoded a pass), its shared loads, global
    loads and stores, and the lengths of the loops nested in it; None
    where no such loop. The counts are static: a nested loop counts once
    and every branch's both sides count (the replaced design's plane
    loop, unrolled by 4, runs once at k = 4 to 7, and its three remainder
    planes are all counted, of which k = 5 runs one and k = 6 two)."""
    found = hist_split.loop_range(code, mem)
    if found is None:
        return None
    lo, hi = found
    body = [opcode(t) for a, t in code if lo <= a <= hi]
    inner = [sum(1 for a2, _ in code if a <= a2 <= b)
             for a, b in hist_split._loops(code)
             if lo <= a and b <= hi and (a, b) != (lo, hi)]
    n_int = sum(op in _INT_OPS for op in body)
    return dict(loop=len(body), int=n_int, lds=body.count("LDS"),
                ldg=body.count("LDG"), stg=body.count("STG"),
                inner=inner or None, per_register=len(body) / regs,
                int_per_register=n_int / regs)


def sass_counts(path, keep=None):
    """listing_counts of cuobjdump's listing of the library (None where
    cuobjdump is not installed); with keep, the listing is written
    there."""
    sass = hist_split.sass_listing(path, keep)
    return None if sass is None else listing_counts(sass)


def listing_counts(sass):
    """{k: {variant: loop_record}} at k = 5 and 6 of a cuobjdump -sass
    listing (a variant None where its kernel is not found)."""
    funcs = hist_split._functions(sass)
    out = {}
    for k in (5, 6):
        out[k] = {}
        for v, (parts, regs, mem) in sass_names(k).items():
            code = next((c for f, c in funcs.items()
                         if all(p in f for p in parts)), None)
            out[k][v] = (None if code is None
                         else loop_record(code, regs, mem))
    return out


def build():
    """(library path, build seconds, nvcc log) of unpack_split.cu, built
    into the package's build directory under a name hashed from it and
    the kernel's source; seconds 0.0 and an empty log where it existed."""
    return _build.build_probe(SOURCE, "regpack_unpack", "unpack_split")


def load(path):
    lib = ctypes.CDLL(path)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.unpack_split_run.argtypes = [I, I, P, LL, LL, P, P, I, P]
    lib.unpack_split_run.restype = I
    lib.unpack_split_occupancy.argtypes = [I]
    lib.unpack_split_occupancy.restype = I
    return lib


def occupancy(lib):
    """{variant: CTAs an SM at k = 5} as the runtime computes them."""
    return {v: lib.unpack_split_occupancy(i) for v, i in VARIANTS.items()}


def _launcher(lib, variant, packed, k, d_table, out):
    """fn(reps) that launches `variant` reps times over the planes."""
    stream = torch.cuda.current_stream().cuda_stream
    s, _, r8 = packed.shape

    def fn(reps):
        err = lib.unpack_split_run(VARIANTS[variant], k, packed.data_ptr(),
                                   s, r8, d_table.data_ptr(),
                                   out.data_ptr(), reps, stream)
        if err != 0:
            raise RuntimeError(f"unpack_split {variant}: cudaError_t {err}")
    return fn


def slabs(seed, regs_16k=None):
    """Yields (label, host rows) one 128 MiB slab at a time: the first
    SLAB_ROWS rows of the N=16384 bench bank (regs_16k where given) and
    SLAB_ROWS rows of 2^14 registers over 33 values of 0..63 (k = 6, as
    chip_smoke.py draws them)."""
    regs = hist_split.bench_16k(seed) if regs_16k is None else regs_16k
    yield "bench bank slab", np.ascontiguousarray(regs[:SLAB_ROWS])
    del regs
    rng = np.random.default_rng(0x6B)
    vals = rng.choice(64, 33, replace=False).astype(np.uint8)
    yield "k=6 slab", rng.choice(vals, size=(SLAB_ROWS, 1 << 14))


def slab_record(lib, label, rows, dev, card, reps=20, out=print):
    """The variants on one host slab, packed with its own alphabet: every
    variant that computes the rows checked against the plain version (and
    the host rows), then each variant timed in two turns (the second in
    the reverse order) and the wrapper once between them. Returns the
    JSON record."""
    lut, table, k = regpack.plan_pack(regpack.host_values(rows))
    packed = torch.from_numpy(regpack.pack_rows(rows, lut, k)).to(dev)
    d_table = torch.from_numpy(table).to(dev)
    s, r = rows.shape
    want = torch.empty((s, r), dtype=torch.uint8, device=dev)
    regpack._unpack_rows_plain(want, packed, d_table, 0, k)
    host_equal = bool(np.array_equal(want.cpu().numpy(), rows))
    got = torch.empty_like(want)
    equal = {}
    for v in COMPUTING:
        got.fill_(0xA5)
        _launcher(lib, v, packed, k, d_table, got)(1)
        torch.cuda.synchronize()
        equal[v] = bool(torch.equal(got, want))
    del want
    ms = {v: _ms(torch, _launcher(lib, v, packed, k, d_table, got), reps)
          for v in VARIANTS}
    wrapper_ms = _ms(torch, lambda n: [regpack.unpack_rows(
        got, packed, d_table, 0, k) for _ in range(n)], reps)
    ms2 = {v: _ms(torch, _launcher(lib, v, packed, k, d_table, got), reps)
           for v in reversed(VARIANTS)}
    nbytes = packed.numel() + d_table.numel() + s * r
    half = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    half_out = torch.empty_like(half)
    copy_ms = _ms(torch, lambda n: [half_out.copy_(half) for _ in range(n)],
                  reps)
    del half, half_out
    bound_ms, bound_by = bound((k + 1) * s * r / hopper.INT32_OPS_PER_S,
                               nbytes / hopper.HBM_BYTES_PER_S)
    share = {v: bound_ms / min(ms[v], ms2[v]) for v in VARIANTS}
    rec = dict(shape=label, rows=s, registers=r, k=k, card=card,
               host_equal=host_equal, equal=equal, ms=ms, ms2=ms2,
               wrapper_ms=wrapper_ms, copy_ms=copy_ms, bound_ms=bound_ms,
               bound_by=bound_by,
               bytes=nbytes, share=share)
    out(f"  [{card}] unpack_split {label} (k={k}, {s} x {r}, {nbytes} "
        "bytes): " + ", ".join(f"{v} {ms[v]:.4f} / {ms2[v]:.4f}"
                               for v in VARIANTS)
        + f" ms (two turns, the launch alone); wrapper {wrapper_ms:.4f} ms; "
        f"a device copy of the same bytes (half read, half written) "
        f"{copy_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms ({bound_by}), kernel share "
        f"{share['kernel']:.3f}; bit-equal to plain: {equal}; plain equal "
        f"to the host rows: {host_equal}", flush=True)
    del packed, got
    torch.cuda.empty_cache()
    return rec


def main(argv=None):
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass-out", default=None,
                    help="write the library's whole SASS listing here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("unpack_split: needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    path, secs, log = build()
    print(f"built {os.path.basename(path)} in {secs:.2f} s")
    for ln in ptxas_lines(log):
        print(f"  ptxas {ln}")
    spills = [ln for ln in log.splitlines() if "spill" in ln and
              "0 bytes spill stores, 0 bytes spill loads" not in ln]
    lib = load(path)
    print(f"  CTAs an SM (k = 5): {json.dumps(occupancy(lib))}")
    counts = sass_counts(path, args.sass_out)
    for k, recs in (counts or {}).items():
        print(f"  SASS of each loop at k = {k}: {json.dumps(recs)}")
    dev = torch.device("cuda")
    ok = not spills
    if spills:
        print(f"  ptxas spills registers: {spills}")
    for label, rows in slabs(args.seed):
        rec = slab_record(lib, label, rows, dev, card, args.reps)
        rec["sass"] = None if counts is None else counts.get(rec["k"])
        print(json.dumps(rec), flush=True)
        ok &= all(rec["equal"].values()) and rec["host_equal"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
