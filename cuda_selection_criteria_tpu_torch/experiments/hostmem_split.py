"""First-touch page faults of the port's host stages, with glibc's arena
reuse (utils/hostmem.enable_arena_reuse) off and on.

    python3 -m cuda_selection_criteria_tpu_torch.experiments.hostmem_split \\
        [--stages abcde] [--turns off,on,on,off] [--out FILE.json] \\
        [--device cuda:0] [--tiny]

A process of its own builds the kernels and libfastx and makes every
stage's inputs once under a temporary directory; then each stage runs in
a fresh interpreter once a turn, in the order of
--turns (reuse off, on, on, off by default). A child with reuse on calls
enable_arena_reuse() before it imports torch or the package's engines; a
child with reuse off never calls it, and fails if anything else did. No
child imports JAX or the JAX package (whose import turns reuse on by
itself). Each child reports its stage's wall and sub-stages: the wall, the
getrusage(RUSAGE_SELF) ru_minflt / ru_majflt deltas around each span that
the script can bracket (the engine's functions wrapped on the main thread:
ScreenPlan, upload_sorted_rows, prune_tiles, screen_tiles, confirm,
ertl_mle_batch, the loaders, the build), the engine's own stats and
ru_maxrss with VmHWM. Where the host's getrusage counts no faults (the
H100 host of PERF.md reports 0), the walls are what the profile shows.
The stages:

  a  probe    a fresh 256 MiB numpy array touched, freed, and a second one
              touched (MB/s and faults of each); the same on a worker
              thread, and 32 MiB on a worker thread (a thread's own arena
              holds at most 64 MiB)
  b  rep      the cells' rep path, SketchBank.from_arrays(cards=None) ->
              select_pairs(tau 0.9) -> format_results, three reps a bank:
              N=16,384 with aux HLLs at p_aux=8 (the hll_a cell's shape,
              2048 hashes a genome) and chip_smoke.py phase 11's planted
              N=131,072 smh bank (experiments/validate_131k_scale)
  c  confirm  selection -c baseline -h 0.01 (compare_engines' operating
              point) on chip_smoke.py phase 4's 2048 sketch files, through
              the library: the confirm stage and ertl_mle_batch apart
  d  load     phase 4's loaders (load_hll_bank at p=14 and 8,
              load_smh_bank) of 2048 files on 8 threads, and the npz bank
              checkpoint of the N=16,384 bank (SketchBank.save / load)
  e  build    build_bank_from_files(backend="native", 8 threads), smh_a
              -a 256, on chip_smoke.py phase 7's 0.31 Gbp synthetic corpus

Each stage's output lines or bank bytes must be equal in every turn, or
the script exits 1. Prints the card's name and power limit and the host's
glibc version, THP mode, cores, CPU model and RAM once, one line a child,
a table a stage (a span a row, a turn a column: seconds, minor and major
faults) and one JSON line (also written to --out). Stages b and c run on
--device (one CUDA card by default); --tiny cuts every size for a
rehearsal on the CPU. The parent does not call enable_arena_reuse: each
child chooses.
"""

import argparse
import contextlib
import functools
import hashlib
import json
import os
import platform
import resource
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from ..utils import hostmem

STAGES = "abcde"
THREAD_SMALL_MIB = 32
SIZES = {  # full, tiny
    "n_hll": (16384, 512), "n_smh": (131072, 1024), "n_files": (2048, 256),
    "corpus": ((96, (5e5, 6e6)), (24, (2e4, 6e4))), "probe_mib": (256, 16),
}
REPS = {"b": 3, "c": 2, "d": 2, "e": 2}
THREADS = 8
CHILD_TIMEOUT = 900


def host_facts():
    """The host's glibc version, THP mode (read only), cores, CPU model
    and RAM."""
    try:
        with open("/sys/kernel/mm/transparent_hugepage/enabled") as fh:
            thp = fh.read().strip()
    except OSError:
        thp = "unavailable"
    model = platform.processor() or "unknown"
    ram = None
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as fh:
            model = next((ln.split(":", 1)[1].strip() for ln in fh
                          if ln.startswith("model name")), model)
        with open("/proc/meminfo") as fh:
            ram = next(int(ln.split()[1]) * 1024 for ln in fh
                       if ln.startswith("MemTotal:"))
    try:
        libc = os.confstr("CS_GNU_LIBC_VERSION")
    except (ValueError, OSError):
        libc = None
    return {"glibc": libc, "thp": thp, "cores": os.cpu_count(),
            "cpu_model": model, "ram_bytes": ram}


def card_line():
    """nvidia-smi's name and power limit of the first card, or "no card"
    where there is none (the --tiny CPU rehearsal)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no card"
    return out.splitlines()[0]


def _faults():
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_minflt, r.ru_majflt


def _maxrss_bytes():
    """(ru_maxrss, VmHWM) in bytes. On Linux ru_maxrss starts at the
    resident set of the process that forked this one (it survives fork
    and exec), which main keeps small; VmHWM, where the kernel reports it
    (None elsewhere), is this interpreter's own peak."""
    hwm = None
    with contextlib.suppress(OSError):
        with open("/proc/self/status") as fh:
            hwm = next((int(ln.split()[1]) * 1024 for ln in fh
                        if ln.startswith("VmHWM:")), None)
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024, hwm


class Meter:
    """Wall, minor and major faults of named spans (a span a key, nested
    spans joined by "/"), summed over calls. Spans are opened on the main
    thread only: RUSAGE_SELF counts every thread, so a wrapped function
    called on a worker thread runs unmeasured."""

    def __init__(self):
        self.spans = {}
        self.notes = {}
        self._prefix = []

    @contextlib.contextmanager
    def span(self, name):
        key = "/".join(self._prefix + [name])
        self._prefix.append(name)
        f0, j0 = _faults()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            secs = time.perf_counter() - t0
            f1, j1 = _faults()
            self._prefix.pop()
            rec = self.spans.setdefault(
                key, {"calls": 0, "secs": 0.0, "minflt": 0, "majflt": 0})
            rec["calls"] += 1
            rec["secs"] += secs
            rec["minflt"] += f1 - f0
            rec["majflt"] += j1 - j0

    def wrap(self, owner, attr, name, after=None):
        """Measure every main-thread call of owner.attr as span `name`;
        after(args, result), if given, runs once the call returns."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            if threading.current_thread() is not threading.main_thread():
                return fn(*args, **kw)
            with self.span(name):
                out = fn(*args, **kw)
            if after is not None:
                after(args, out)
            return out

        setattr(owner, attr, wrapped)


def _sha(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(memoryview(np.ascontiguousarray(a)).cast("B"))
    return h.hexdigest()


def _lines_sha(lines):
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


# --------------------------------------------------------------------------
# inputs (the parent, once a call)
# --------------------------------------------------------------------------


def make_inputs(d, stages, tiny):
    """Every input the stages read, written under d."""
    from ..models import SketchBank
    from ..utils import formats, synth
    from . import validate_131k_scale

    size = {k: v[tiny] for k, v in SIZES.items()}
    if "b" in stages or "d" in stages:
        t0 = time.perf_counter()
        rng = np.random.default_rng(0x4A11)
        regs, aux = synth.synthetic_hll_banks(size["n_hll"], 2048, (14, 8),
                                              rng)
        synth.plant_near_duplicates(regs, aux, rng, 300)
        np.save(os.path.join(d, "hll_regs.npy"), regs)
        np.save(os.path.join(d, "hll_aux.npy"), aux)
        if "d" in stages:
            SketchBank.from_arrays([f"h{i:05d}" for i in range(len(regs))],
                                   regs, aux=aux, aux_kind="hll",
                                   aux_param=8).save(
                os.path.join(d, "bank16k.npz"))
        print(f"  inputs: N={len(regs)} hll bank made in "
              f"{time.perf_counter() - t0:.1f} s")
    if "b" in stages:
        bank, _, secs = validate_131k_scale.make_bank(size["n_smh"])
        np.save(os.path.join(d, "smh_regs.npy"), bank.regs)
        np.save(os.path.join(d, "smh_aux.npy"), bank.aux)
        print(f"  inputs: N={bank.n} planted smh bank made in {secs:.1f} s")
        del bank
    if "c" in stages or "d" in stages:
        t0 = time.perf_counter()
        regs, hll, aux = synth.planted_file_banks(size["n_files"])
        names = [os.path.join(d, f"g{i:04d}.fna.gz")
                 for i in range(len(regs))]
        for name, r, a, h in zip(names, regs, aux, hll):
            formats.write_hll(name + ".hll", 14, r)
            formats.write_smh(name + ".smh32", a)
            formats.write_hll(name + ".hll_8", 8, h)
        with open(os.path.join(d, "files.txt"), "w") as fh:
            fh.write("\n".join(names) + "\n")
        print(f"  inputs: {len(names)} x 3 sketch files written in "
              f"{time.perf_counter() - t0:.1f} s")
    if "e" in stages:
        t0 = time.perf_counter()
        n_base, len_range = size["corpus"]
        cdir = os.path.join(d, "corpus")
        os.makedirs(cdir)
        files, _, _, bases = synth.write_fasta_corpus(
            cdir, 0xFA57A, n_base=n_base, len_range=len_range)
        with open(os.path.join(d, "corpus.txt"), "w") as fh:
            fh.write("\n".join(files) + "\n")
        print(f"  inputs: corpus of {len(files)} files, {bases} bases, "
              f"written in {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# stages (a child each)
# --------------------------------------------------------------------------


def _touch(mib):
    """Allocate and touch a fresh mib-MiB numpy array, then free it:
    (MB/s, minor faults, major faults)."""
    f0, j0 = _faults()
    t0 = time.perf_counter()
    a = np.empty(mib << 20, np.uint8)
    a.fill(1)
    secs = time.perf_counter() - t0
    f1, j1 = _faults()
    del a
    return {"mb_per_s": (mib << 20) / secs / 1e6, "secs": secs,
            "minflt": f1 - f0, "majflt": j1 - j0}


def stage_probe(meter, ctx):
    mib = ctx["size"]["probe_mib"]
    rec = {"main": [_touch(mib), _touch(mib)]}
    for label, m in (("thread", mib), ("thread_small", THREAD_SMALL_MIB)):
        box = []
        # both touches on one worker thread: its own arena
        th = threading.Thread(target=lambda m=m: box.extend(
            [_touch(m), _touch(m)]))
        th.start()
        th.join(timeout=120)
        if th.is_alive() or len(box) != 2:
            raise RuntimeError(f"probe {label}: the worker thread did not "
                               "finish")
        rec[label] = box
    meter.notes["probe"] = rec
    return {"probe": "ones"}


def _plan_hooks(meter):
    """Wrap the screened engine's stages; the plan's upload_stats go to
    meter.notes["upload_stats"] (one list entry a plan)."""
    from ..parallel import screened
    from ..utils import hostref

    def keep_upload_stats(args, _):
        meter.notes.setdefault("upload_stats", []).append(
            dict(args[0].upload_stats, upload_secs=args[0].upload_secs))

    meter.wrap(screened.ScreenPlan, "__init__", "plan",
               after=keep_upload_stats)
    meter.wrap(screened, "upload_sorted_rows", "upload_sorted_rows")
    meter.wrap(screened.ScreenPlan, "schedule", "schedule")
    meter.wrap(screened.ScreenPlan, "prune_tiles", "prune")
    meter.wrap(screened.ScreenPlan, "screen_tiles", "screen")
    meter.wrap(screened.ScreenPlan, "confirm", "confirm")
    meter.wrap(hostref, "ertl_mle_batch", "ertl_mle_batch")


def stage_rep(meter, ctx):
    from ..models import SketchBank
    from ..parallel.selection import (SelectionParams, format_results,
                                      select_pairs)

    _plan_hooks(meter)
    d, dev = ctx["workdir"], ctx["device"]
    digests, stats = {}, {}
    for label, kind, param, crit in (("hll_a-16k", "hll", 8, "hll_a"),
                                     ("smh_a-131k", "smh", 32, "smh_a")):
        with meter.span(f"{label}/inputs"):
            regs = np.load(os.path.join(d, f"{kind}_regs.npy"))
            aux = np.load(os.path.join(d, f"{kind}_aux.npy"))
        names = [f"{kind}{i:06d}" for i in range(len(regs))]
        # explicit "screened": what "auto" resolves to on one card, kept
        # on the CPU rehearsal too
        params = SelectionParams(tau=0.9, criterion=crit, engine="screened")
        for rep in range(REPS["b"]):
            st = {}
            with meter.span(f"{label}/rep{rep}"):
                with meter.span("from_arrays"):
                    bank = SketchBank.from_arrays(names, regs, cards=None,
                                                  aux=aux, aux_kind=kind,
                                                  aux_param=param)
                with meter.span("select_pairs"):
                    out = select_pairs(bank, params, device=dev, stats=st)
                with meter.span("format_results"):
                    lines = format_results(out)
            digests.setdefault(label, _lines_sha(lines))
            if digests[label] != _lines_sha(lines):
                raise RuntimeError(f"{label} rep {rep}: lines differ from "
                                   "rep 0")
            stats[f"{label}/rep{rep}"] = dict(st, lines=len(lines))
            del bank, out
        meter.notes[f"{label}/maxrss_hwm_bytes"] = _maxrss_bytes()
        del regs, aux
    meter.notes["stats"] = stats
    return digests


def _file_list(ctx, name):
    with open(os.path.join(ctx["workdir"], name)) as fh:
        return [ln.strip() for ln in fh if ln.strip()]


def stage_confirm(meter, ctx):
    from ..models import SketchBank
    from ..parallel.selection import (SelectionParams, format_results,
                                      select_pairs)

    _plan_hooks(meter)
    files = _file_list(ctx, "files.txt")
    with meter.span("inputs"):
        bank = SketchBank.from_sketch_files(files, criterion=None,
                                            io_threads=THREADS)
    params = SelectionParams(tau=0.01, criterion="baseline",
                             engine="screened")
    digest, stats = None, {}
    for rep in range(REPS["c"]):
        st = {}
        with meter.span(f"rep{rep}"):
            with meter.span("select_pairs"):
                out = select_pairs(bank, params, device=ctx["device"],
                                   stats=st)
            with meter.span("format_results"):
                lines = format_results(out)
        digest = digest or _lines_sha(lines)
        if digest != _lines_sha(lines):
            raise RuntimeError(f"confirm rep {rep}: lines differ from rep 0")
        stats[f"rep{rep}"] = dict(st, lines=len(lines))
        del out
    meter.notes["stats"] = stats
    return {"baseline-0.01": digest}


def stage_load(meter, ctx):
    from ..models import SketchBank
    from ..models import bank as bank_mod

    files = _file_list(ctx, "files.txt")
    readers = (("load_hll_bank p=14", lambda: bank_mod.load_hll_bank(
                    [f + ".hll" for f in files], 14, THREADS)),
               ("load_hll_bank p=8", lambda: bank_mod.load_hll_bank(
                   [f + ".hll_8" for f in files], 8, THREADS)),
               ("load_smh_bank m=32", lambda: bank_mod.load_smh_bank(
                   [f + ".smh32" for f in files], 32, THREADS)))
    npz = os.path.join(ctx["workdir"], "bank16k.npz")
    digests = {}
    for rep in range(REPS["d"]):
        got = {}
        for label, fn in readers:
            with meter.span(f"rep{rep}/{label}"):
                got[label] = fn()
        with meter.span(f"rep{rep}/SketchBank.load npz"):
            b = SketchBank.load(npz)
        got["npz"] = (b.regs, b.aux, b.cards)
        for label, arrays in got.items():
            sha = _sha(*(arrays if isinstance(arrays, tuple) else (arrays,)))
            if digests.setdefault(label, sha) != sha:
                raise RuntimeError(f"load {label} rep {rep}: bytes differ")
        del got, b
    return digests


def stage_build(meter, ctx):
    from ..models import bank as bank_mod

    files = _file_list(ctx, "corpus.txt")
    digest, stats = None, {}
    for rep in range(REPS["e"]):
        st = {}
        with meter.span(f"rep{rep}/build_bank_from_files native"):
            b = bank_mod.build_bank_from_files(
                files, "smh_a", aux_bytes=256, io_threads=THREADS,
                backend="native", stats=st)
        sha = _sha(b.regs, b.aux)
        digest = digest or sha
        if digest != sha:
            raise RuntimeError(f"build rep {rep}: bank bytes differ")
        stats[f"rep{rep}"] = st
        del b
    meter.notes["stats"] = stats
    return {"smh_a-256": digest}


STAGE_FNS = {"a": stage_probe, "b": stage_rep, "c": stage_confirm,
             "d": stage_load, "e": stage_build}


def run_child(args):
    """One stage in this fresh interpreter: prints its record as the last
    line of stdout."""
    enabled = (hostmem.enable_arena_reuse() if args.reuse == "on"
               else None)
    meter = Meter()
    ctx = {"workdir": args.workdir, "device": args.device,
           "size": {k: v[args.tiny] for k, v in SIZES.items()}}
    f0, j0 = _faults()
    t0 = time.perf_counter()
    digests = STAGE_FNS[args.child](meter, ctx)
    wall = time.perf_counter() - t0
    f1, j1 = _faults()
    if args.device.startswith("cuda") and "torch" in sys.modules:
        import torch
        torch.cuda.synchronize()
    jax_loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m.split(".")[0] == "cuda_selection_criteria_tpu")
    print(json.dumps({
        "stage": args.child, "reuse": args.reuse, "turn": args.turn,
        "enabled": enabled, "enabled_at_end": hostmem._enabled,
        "jax_loaded": jax_loaded, "wall": wall, "minflt": f1 - f0,
        "majflt": j1 - j0, "maxrss_hwm_bytes": _maxrss_bytes(),
        "spans": meter.spans, "notes": meter.notes, "digests": digests},
        default=str))
    return 0


# --------------------------------------------------------------------------
# the parent
# --------------------------------------------------------------------------


def run_inputs(args):
    """The inputs' process: the kernels' and libfastx's builds (the
    children load them from disk) and every stage's inputs."""
    stages = [s for s in args.stages if s in STAGES]
    if args.device.startswith("cuda") and ("b" in stages or "c" in stages):
        from ..ops import _build
        _build.build()
    from ..native import fastx
    fastx.info()
    make_inputs(args.workdir, stages, args.tiny)
    return 0


def spawn(label, argv, args):
    """Run this script with argv in a fresh interpreter (the --device and
    --tiny of args): its stdout, or raises."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    cmd = [sys.executable, "-m", __spec__.name, *argv, "--device",
           args.device] + (["--tiny"] if args.tiny else [])
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=root, timeout=CHILD_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"{label} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout


def check_records(recs):
    """Problems across one stage's turns: digests that differ, a child
    with reuse off whose allocator someone else switched, JAX loaded."""
    bad = []
    for r in recs:
        if r["digests"] != recs[0]["digests"]:
            bad.append(f"stage {r['stage']} turn {r['turn']} ({r['reuse']}):"
                       " outputs differ from turn 0")
        if r["reuse"] == "off" and r["enabled_at_end"] is not None:
            bad.append(f"stage {r['stage']} turn {r['turn']}: reuse off, "
                       "but enable_arena_reuse was called")
        if r["jax_loaded"]:
            bad.append(f"stage {r['stage']} turn {r['turn']} imported "
                       f"{r['jax_loaded'][:3]}")
    return bad


def table(recs, card):
    """One row a span: seconds, minor and major faults a turn."""
    stage = recs[0]["stage"]
    keys = []
    for r in recs:
        keys += [k for k in r["spans"] if k not in keys]
    head = " | ".join(f"{r['reuse']}{r['turn']}" for r in recs)
    print(f"  [{card}] stage {stage}: span | {head} (s minflt majflt)")
    rows = [("(stage)", [(r["wall"], r["minflt"], r["majflt"])
                         for r in recs])]
    for k in keys:
        rows.append((k, [(r["spans"][k]["secs"], r["spans"][k]["minflt"],
                          r["spans"][k]["majflt"]) if k in r["spans"]
                         else None for r in recs]))
    for k, cells in rows:
        print(f"    {k} | " + " | ".join(
            "-" if c is None else f"{c[0]:.4f} {c[1]} {c[2]}"
            for c in cells))
    if stage == "a":
        if not any(t["minflt"] for r in recs
                   for touches in r["notes"]["probe"].values()
                   for t in touches):
            print("    this host's getrusage counts no page faults (every "
                  "probe's delta is 0): read the walls")
        for r in recs:
            probe = r["notes"]["probe"]
            print(f"    probe {r['reuse']}{r['turn']}: " + "; ".join(
                f"{where} " + ", ".join(
                    f"{t['mb_per_s']:.0f} MB/s {t['minflt']} faults"
                    for t in touches) for where, touches in probe.items()))
    print("    ru_maxrss, VmHWM " + " | ".join(
        "{}, {}".format(*r["maxrss_hwm_bytes"]) for r in recs)
        + "; enable_arena_reuse() " + " | ".join(
            str(r["enabled"]) for r in recs))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--stages", default=STAGES)
    ap.add_argument("--turns", default="off,on,on,off")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--tiny", action="store_true",
                    help="every size cut, for a rehearsal on the CPU")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--child", choices=list(STAGES), help=argparse.SUPPRESS)
    ap.add_argument("--reuse", choices=["on", "off"], help=argparse.SUPPRESS)
    ap.add_argument("--turn", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return run_child(args)
    if args.inputs:
        return run_inputs(args)

    stages = [s for s in args.stages if s in STAGES]
    turns = args.turns.split(",")
    if any(t not in ("on", "off") for t in turns):
        ap.error("--turns takes on and off")
    t_start = time.perf_counter()
    card = card_line()
    facts = host_facts()
    print(card)
    print(f"host: glibc {facts['glibc']}; THP {facts['thp']}; "
          f"{facts['cores']} cores ({facts['cpu_model']}); RAM "
          f"{facts['ram_bytes']} bytes")
    results, bad = {}, []
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        # a process of its own, so that this one stays small: a child's
        # ru_maxrss starts at the resident set of the process it forks from
        made = spawn("the inputs", ["--inputs", "--workdir", d, "--stages",
                                    "".join(stages)], args).rstrip()
        if made:
            print(made)
        print(f"  inputs and builds made in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for stage in stages:
            recs = []
            for turn, reuse in enumerate(turns):
                out = spawn(f"stage {stage} reuse {reuse} turn {turn}",
                            ["--child", stage, "--reuse", reuse, "--turn",
                             str(turn), "--workdir", d], args)
                rec = json.loads(out.strip().splitlines()[-1])
                print(f"  [{card}] stage {stage} turn {turn} reuse {reuse}: "
                      f"wall {rec['wall']:.3f} s, minflt {rec['minflt']}, "
                      f"majflt {rec['majflt']}, ru_maxrss, VmHWM "
                      "{}, {} bytes".format(*rec["maxrss_hwm_bytes"])
                      + f", enable_arena_reuse() {rec['enabled']}",
                      flush=True)
                recs.append(rec)
            table(recs, card)
            bad += check_records(recs)
            results[stage] = recs
    total = time.perf_counter() - t_start
    print(f"total {total:.1f} s")
    record = {"card": card, "host": facts, "turns": turns,
              "stages": results, "total_secs": total, "equal": not bad}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(record, fh, default=str)
    print(json.dumps({"card": card, "host": facts, "equal": not bad,
                      "total_secs": total}))
    for msg in bad:
        print(f"hostmem_split: FAILED: {msg}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
