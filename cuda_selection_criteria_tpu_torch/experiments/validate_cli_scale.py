"""The selection CLI from sketch files at a curator's collection size,
held pair by pair to the exact host cascade. The port's counterpart of the
JAX package's experiments/validate_real_scale.py protocol from the sketch
files onward (its FASTA front end needs the reference's genomes).

    draw     utils/synth.genome_file_bank: N real-sized genomes (2^20 to
             2^24 hashes a genome, log-uniform, so CB prunes) at p=14 with
             32 SMH buckets, --planted pairs of Jaccard 0.80-1.00
    write    .hll / .smh32 files (utils/formats, the reference's bytes) and
             their list, on -t forked processes (on threads of one
             process the writes did not run in parallel), into --workdir;
             a manifest lets a later call with the same draw reuse them
             (set-up, timed apart)
    run      python -m cuda_selection_criteria_tpu_torch.cli.selection -l
             <list> -t T -a 256 -h 0.9 -c smh_a in a fresh interpreter:
             the user's wall and lines; then cli.main in this process for
             the stage split, the kernels' launches and the walls of its
             SketchBank.from_sketch_files loads, whose arrays must be
             byte-equal to the draw and served by the native batch readers
    check    every printed line passes hostref.PairOracle over the
             cardinality-sorted bank (CB included) with the same J string;
             each planted pair and 100,000 seeded random pairs is printed
             if and only if the cascade accepts it; the CLI on a
             sub-collection of --sub genomes (every planted row, seeded
             random rows) prints select_pairs_host's lines; no module of
             jax, jaxlib, flax or cuda_selection_criteria_tpu is loaded
             here or in the child

Prints readable lines and one JSON record; a failed check prints what
differs and exits 1. Runs on the card unless --device cpu is given (then
the CLI runs --engine screened through the kernels' plain versions); it
has no fallback.

    python -m cuda_selection_criteria_tpu_torch.experiments.\\
validate_cli_scale [--n 596859] [--seed 0] [--planted 256] [-t 8]
        [--workdir DIR] [--sub 8192] [--device cuda]
"""

import argparse
import contextlib
import io
import json
import multiprocessing
import os
import resource
import shutil
import subprocess
import sys
import threading
import time
import warnings
import zlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from ..cli import selection as cli
from ..models import bank as bank_mod
from ..native import fastx
from ..ops import estimators, screen
from ..parallel import screened
from ..parallel import selection as sel
from ..utils import formats, hopper, hostmem, hostref, synth

PKG = "cuda_selection_criteria_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKDIR = os.path.join(ROOT, PKG, "build", "cli_scale")
P, M = 14, 32
CRITERION = "smh_a"
AUX_BYTES = 8 * M
TAU = 0.9
PROBE_PAIRS = 100_000
# A genome's files on disk: a gzipped .hll of a real-sized row is about
# 7.2 KB and the .smh32 about 0.3 KB, so three 4 KiB blocks and their
# directory entries.
DISK_BYTES_A_GENOME = 3 * 4096 + 256
# rows a writer's task: a divisor of GENOME_CHUNK, so a task's files share
# one folder
WRITE_ROWS = 512
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_selection_criteria_tpu")
LAUNCHES = {"K1": (screen.screen_hits_fused, screen.screen_hits_fused_strips),
            "G": (screen.gate_counts,), "H": (screen.row_hist,),
            "M": (estimators.ertl_mle,), "F": (screened.band_fingerprints,)}


class CheckFailed(RuntimeError):
    """A check of the run against the host cascade failed."""


def forbidden_modules(names):
    """The names among `names` of jax, jaxlib, flax or the JAX package."""
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def genome_names(workdir, n):
    """The genomes' names: one folder a GENOME_CHUNK of rows."""
    return [os.path.join(workdir, f"c{i // synth.GENOME_CHUNK:04d}",
                         f"g{i:07d}.fna.gz") for i in range(n)]


def manifest_of(args, regs, aux):
    """What a work directory's files were written from: the draw's
    parameters and a digest of its first and last rows."""
    crc = 0
    for a in (regs[0], regs[-1], aux[0], aux[-1]):
        crc = zlib.crc32(a.tobytes(), crc)
    return {"n": args.n, "seed": args.seed, "planted": args.planted, "p": P,
            "m": M, "digest": f"{crc:08x}"}


def write_files(workdir, regs, aux, threads, manifest):
    """Write the bank's .hll / .smh32 files and their list into workdir,
    unless its manifest says they hold this draw. Returns (list path,
    {"reused", "write_secs", "bytes_on_disk"})."""
    n = len(regs)
    names = genome_names(workdir, n)
    lst = os.path.join(workdir, "list.txt")
    mpath = os.path.join(workdir, "manifest.json")
    os.makedirs(workdir, exist_ok=True)
    old = None
    if os.path.exists(mpath):
        with open(mpath) as fh:
            old = json.load(fh)
        if {k: old.get(k) for k in manifest} == manifest and \
                os.path.exists(lst):
            return lst, {"reused": True, "write_secs": 0.0,
                         "bytes_on_disk": old["bytes_on_disk"]}
        os.remove(mpath)
        # the earlier draw's files go first, so the space check counts them
        # as free
        with ThreadPoolExecutor(max(1, threads)) as pool:
            list(pool.map(_remove_genome, genome_names(workdir, old["n"])))
    need = n * DISK_BYTES_A_GENOME
    free = shutil.disk_usage(workdir).free
    if free < need:
        raise OSError(f"{workdir}: the {n} genomes' files need about {need} "
                      f"bytes of disk, {free} are free")
    t0 = time.perf_counter()
    # the workers get the rows by fork, not through a pipe. They run only
    # numpy slicing, zlib and file writes, and take no lock that another
    # thread of this process (torch's, the card's) may hold at the fork.
    _TO_WRITE.update(names=names, regs=regs, aux=aux)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", ".*multi-threaded.*fork",
                                    DeprecationWarning)
            with ProcessPoolExecutor(max(1, threads), mp_context=(
                    multiprocessing.get_context("fork"))) as pool:
                size = sum(pool.map(_write_rows, range(0, n, WRITE_ROWS)))
    finally:
        _TO_WRITE.clear()
    with open(lst, "w") as fh:
        fh.write("\n".join(names) + "\n")
    secs = time.perf_counter() - t0
    with open(mpath, "w") as fh:
        json.dump(dict(manifest, bytes_on_disk=size, write_secs=secs), fh)
    return lst, {"reused": False, "write_secs": secs, "bytes_on_disk": size}


# What write_files' forked workers write: the genomes' names, regs and aux.
_TO_WRITE = {}


def _write_rows(s0):
    """Write the files of the WRITE_ROWS rows of _TO_WRITE from s0 on;
    returns their bytes on disk."""
    names, regs, aux = (_TO_WRITE[k] for k in ("names", "regs", "aux"))
    os.makedirs(os.path.dirname(names[s0]), exist_ok=True)
    size = 0
    for i in range(s0, min(len(names), s0 + WRITE_ROWS)):
        formats.write_hll(names[i] + ".hll", P, regs[i])
        formats.write_smh(names[i] + f".smh{M}", aux[i])
        size += (os.path.getsize(names[i] + ".hll")
                 + os.path.getsize(names[i] + f".smh{M}"))
    return size


def _remove_genome(name):
    for ext in (".hll", f".smh{M}"):
        with contextlib.suppress(FileNotFoundError):
            os.remove(name + ext)


@contextlib.contextmanager
def instrumented(rec):
    """Within it, rec gets the walls of models.bank.load_hll_bank and
    load_smh_bank (load_secs) and the arrays they return (arrays), the wall
    of parallel.selection.format_results (format_secs), and the calls of
    the native batch readers ("native") and of the numpy readers that
    load_*_bank falls back to ("numpy")."""
    rec.update(load_secs={}, arrays={}, format_secs=0.0, native=0, numpy=0)
    saved = []

    def patch(mod, name, wrap):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, wrap(getattr(mod, name)))

    def timed(kind):
        def wrap(fn):
            def inner(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                rec["load_secs"][kind] = time.perf_counter() - t0
                rec["arrays"][kind] = out
                return out
            return inner
        return wrap

    def counted(key):
        def wrap(fn):
            def inner(*a, **kw):
                rec[key] += 1
                return fn(*a, **kw)
            return inner
        return wrap

    def formatted(fn):
        def inner(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            rec["format_secs"] += time.perf_counter() - t0
            return out
        return inner

    patch(bank_mod, "load_hll_bank", timed("hll"))
    patch(bank_mod, "load_smh_bank", timed(f"smh{M}"))
    patch(fastx, "read_hll_batch", counted("native"))
    patch(fastx, "read_smh_batch", counted("native"))
    patch(formats, "read_hll", counted("numpy"))
    patch(formats, "read_smh", counted("numpy"))
    patch(sel, "format_results", formatted)
    try:
        yield rec
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def require_native(rec, what):
    if rec["numpy"] or rec["native"] != 2:
        raise CheckFailed(f"{what}: the native batch readers served "
                          f"{rec['native']} of the 2 loads, the numpy "
                          f"readers read {rec['numpy']} files")


def run_child(lst, args):
    """The user's command in a fresh interpreter (-X importtime lists the
    modules it loads on stderr): (lines, wall seconds, forbidden modules
    it loaded, its /proc status at its largest sampled resident set)."""
    cmd = [sys.executable, "-X", "importtime", "-m", f"{PKG}.cli.selection",
           "-l", lst, "-t", str(args.threads), "-a", str(AUX_BYTES), "-h",
           str(TAU), "-c", CRITERION] + cpu_args(args)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    peak = {}
    watch = threading.Thread(target=_watch_rss, args=(proc, peak))
    watch.start()
    out, err = proc.communicate(timeout=3600)
    wall = time.perf_counter() - t0
    watch.join()
    if proc.returncode:
        raise CheckFailed(f"{' '.join(cmd)} exited {proc.returncode}: "
                          f"{err[-3000:]}")
    loaded = [ln.rsplit("|", 1)[-1].strip() for ln in
              err.splitlines()[1:] if ln.startswith("import time:")]
    return out.splitlines(), wall, forbidden_modules(loaded), peak


RSS_KEYS = ("VmRSS", "RssAnon", "RssFile", "RssShmem", "VmHWM")


def _watch_rss(proc, peak, every=0.2):
    """Sample the child's /proc status every `every` seconds while it runs;
    peak gets the sample of the largest VmRSS, in bytes (nothing where
    /proc is not there)."""
    path = f"/proc/{proc.pid}/status"
    while proc.poll() is None:
        try:
            with open(path) as fh:
                now = {k: int(v.split()[0]) * 1024 for k, v in (
                    ln.split(":", 1) for ln in fh) if k in RSS_KEYS}
        except (OSError, ValueError):
            return
        if now.get("VmRSS", 0) > peak.get("VmRSS", 0):
            peak.clear()
            peak.update(now)
        time.sleep(every)


def cpu_args(args):
    """On the CPU the CLI's auto engine is the dense one: name the card's."""
    return (["--device", "cpu", "--engine", "screened"]
            if args.device == "cpu" else [])


def cli_lines(argv, stats=None):
    """The CLI's lines from cli.main in this process, and its wall."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, stats=stats)
    if rc:
        raise CheckFailed(f"selection {' '.join(argv)} returned {rc}")
    return buf.getvalue().splitlines(), time.perf_counter() - t0


class HostCascade:
    """hostref.PairOracle over the cardinality-sorted bank (host_cards,
    e = trunc, the aux sorted, the union histograms read through the
    order): the exact cascade select_pairs_host runs, CB included, for
    any pairs."""

    def __init__(self, regs, aux, names, cards):
        self.names = names
        self.order = np.argsort(cards, kind="stable")
        self.pos = np.empty(len(names), np.int64)
        self.pos[self.order] = np.arange(len(names))
        self.index = {name: i for i, name in enumerate(names)}
        order = self.order
        self.oracle = hostref.PairOracle(
            P, None, np.trunc(cards[order]), aux=aux[order], aux_param=M,
            criterion=CRITERION, tau=TAU,
            hist_fn=lambda ii, kk: hostref.pair_union_histograms(
                regs, order[ii], order[kk]))

    def keys(self, rows):
        """Sorted-position pairs (i < k) of row pairs (a, b), a != b."""
        i, k = self.pos[rows[:, 0]], self.pos[rows[:, 1]]
        return list(zip(np.minimum(i, k).tolist(), np.maximum(i, k).tolist()))

    def key_of(self, name_a, name_b):
        i, k = self.pos[self.index[name_a]], self.pos[self.index[name_b]]
        return (int(min(i, k)), int(max(i, k)))

    def lines(self, keys):
        """{key: the line the cascade prints for it} of the accepted keys."""
        nm, order = self.names, self.order
        return {(i, k): sel.format_results([(nm[order[i]], nm[order[k]],
                                              j)])[0]
                for i, k, j in self.oracle.confirm_pairs(keys)}

    def label(self, key):
        return (f"{self.names[self.order[key[0]]]} "
                f"{self.names[self.order[key[1]]]}")


def check_lines(lines, cascade, probe):
    """Hold the printed lines to the host cascade: each line is well
    formed, once, in the reference's order, and the line the cascade prints
    for its pair; each pair of `probe` (rows (k, 2)) is printed if and only
    if the cascade accepts it. Raises CheckFailed naming the pair; returns
    the counts."""
    printed = {}
    for ln in lines:
        parts = ln.split(" ")
        if (len(parts) != 3 or parts[0] not in cascade.index
                or parts[1] not in cascade.index):
            raise CheckFailed(f"a printed line names no pair of the bank: "
                              f"{ln!r}")
        key = cascade.key_of(parts[0], parts[1])
        if key in printed:
            raise CheckFailed(f"pair {cascade.label(key)} printed twice")
        printed[key] = ln
    keys = list(printed)
    if keys != sorted(keys):
        raise CheckFailed("the lines are not in the reference's sorted-row "
                          "order")
    want = cascade.lines(keys)
    for key, ln in printed.items():
        if want.get(key) != ln:
            raise CheckFailed(
                f"pair {cascade.label(key)}: printed {ln!r}, the host "
                f"cascade gives {want.get(key, 'no line (it rejects the pair)')!r}")
    probe_keys = sorted(set(k for k in cascade.keys(probe) if k[0] != k[1]))
    accepted = cascade.lines(probe_keys)
    for key in probe_keys:
        if (key in accepted) != (key in printed):
            raise CheckFailed(
                f"pair {cascade.label(key)}: the host cascade "
                + (f"accepts it ({accepted[key]!r}) and the CLI did not "
                   "print it" if key in accepted else
                   f"rejects it and the CLI printed {printed[key]!r}"))
    return {"probe_pairs": len(probe_keys),
            "probe_accepted": len(accepted)}


def sub_rows(n, sub, pairs, seed):
    """Every planted row and seeded random rows, min(sub, n) in all,
    ascending."""
    rows = np.unique(pairs)
    rest = np.setdiff1d(np.arange(n), rows)
    extra = np.random.default_rng([seed, 0x5B]).choice(
        rest, size=max(0, min(sub, n) - len(rows)), replace=False)
    return np.sort(np.concatenate([rows, extra]))


def check_sub(names, regs, aux, rows, args, workdir):
    """The CLI on the sub-collection `rows` of the same files against
    select_pairs_host (exhaustive, CB break) on the drawn rows: lines
    equal as strings."""
    lst = os.path.join(workdir, f"sub_{len(rows)}_{args.seed}.txt")
    files = [names[i] for i in rows]
    with open(lst, "w") as fh:
        fh.write("\n".join(files) + "\n")
    t0 = time.perf_counter()
    got, _ = cli_lines(["-l", lst, "-t", str(args.threads), "-a",
                        str(AUX_BYTES), "-h", str(TAU), "-c",
                        CRITERION] + cpu_args(args))
    t_cli = time.perf_counter() - t0
    t0 = time.perf_counter()
    sub = bank_mod.SketchBank(names=files, regs=regs[rows], aux_kind="smh",
                              aux=aux[rows], aux_param=M)
    want = sel.format_results(hostref.select_pairs_host(
        sub, TAU, CRITERION))
    t_host = time.perf_counter() - t0
    if got != want:
        only_cli = [ln for ln in got if ln not in set(want)]
        only_host = [ln for ln in want if ln not in set(got)]
        raise CheckFailed(f"sub-collection of {len(rows)}: the CLI printed "
                          f"{len(got)} lines, select_pairs_host {len(want)}; "
                          f"only the CLI: {only_cli[:10]}; only the host: "
                          f"{only_host[:10]}")
    return {"sub_genomes": len(rows), "sub_lines": len(got),
            "sub_cli_secs": t_cli, "sub_host_secs": t_host}


def reset_launches():
    for fns in LAUNCHES.values():
        for fn in fns:
            fn.launches = 0


def read_launches():
    return {k: sum(fn.launches for fn in fns) for k, fns in LAUNCHES.items()}


def run(args):
    """The protocol of the module docstring; returns the record. Raises
    CheckFailed when a check fails."""
    if any(c.isspace() for c in args.workdir):
        raise ValueError("--workdir must hold no whitespace: the lines "
                         "are split on spaces")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("validate_cli_scale: no CUDA card (--device cpu "
                         "runs the kernels' plain versions)")
    preloaded = set(forbidden_modules(sys.modules))
    cuda = dev.type == "cuda"
    card = hopper.card_line() if cuda else "cpu"
    print(f"[{card}] validate_cli_scale N={args.n} seed={args.seed} "
          f"planted={args.planted} -t {args.threads}", flush=True)
    rec = {"n": args.n, "seed": args.seed, "planted": args.planted,
           "threads": args.threads, "criterion": CRITERION,
           "device": str(dev), "card": card}

    t0 = time.perf_counter()
    regs, aux, pairs, targets = synth.genome_file_bank(
        args.n, args.seed, args.planted, args.threads, P, M)
    rec["draw_secs"] = time.perf_counter() - t0
    manifest = manifest_of(args, regs, aux)
    rec["digest"] = manifest["digest"]
    lst, wrote = write_files(args.workdir, regs, aux, args.threads, manifest)
    rec.update(wrote)
    names = genome_names(args.workdir, args.n)
    print(f"  set-up: draw {rec['draw_secs']:.1f} s, files "
          f"{'reused' if wrote['reused'] else 'written'} "
          f"({wrote['bytes_on_disk']} bytes) {wrote['write_secs']:.1f} s; "
          f"digest {rec['digest']}", flush=True)

    lines, rec["cli_wall_secs"], child_forbidden, rec["child_rss_peak"] = (
        run_child(lst, args))
    rec["lines"] = len(lines)
    print(f"  [{card}] the user's run: {len(lines)} lines in "
          f"{rec['cli_wall_secs']:.2f} s (fresh interpreter)", flush=True)
    if child_forbidden:
        raise CheckFailed(f"the CLI's process loaded {child_forbidden}")

    argv = ["-l", lst, "-t", str(args.threads), "-a", str(AUX_BYTES), "-h",
            str(TAU), "-c", CRITERION] + cpu_args(args)
    stats, run_rec = {}, {}
    reset_launches()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with instrumented(run_rec):
        again, rec["inproc_wall_secs"] = cli_lines(argv, stats=stats)
    require_native(run_rec, "cli.main")
    rec["launches"] = read_launches()
    rec["peak_device_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda else None)
    rec.update(stats, format_secs=run_rec["format_secs"],
               load_secs=run_rec["load_secs"])
    if again != lines:
        raise CheckFailed("cli.main in this process printed other lines "
                          "than the fresh interpreter")
    loaded = run_rec.pop("arrays")
    # row chunks: one compare of the whole bank would take a bool array of
    # its size
    step = synth.GENOME_CHUNK
    if not (np.array_equal(loaded[f"smh{M}"], aux) and all(
            np.array_equal(loaded["hll"][i:i + step], regs[i:i + step])
            for i in range(0, args.n, step))):
        raise CheckFailed("the bank cli.main loaded differs from the drawn "
                          "one")
    del loaded
    print(f"  [{card}] cli.main in process: {rec['inproc_wall_secs']:.2f} s; "
          + ", ".join(f"{k} {stats[k]:.3f}" for k in (
              "plan_secs", "upload_secs", "cards_secs", "fp_secs",
              "schedule_secs", "prune_secs", "screen_secs", "confirm_secs"))
          + f", format_secs {rec['format_secs']:.3f}; tiles "
          f"{stats['tiles_scheduled']} scheduled / {stats['tiles_live']} "
          f"live, {stats['candidates']} candidates, {stats['confirmed']} "
          f"confirmed, cards_host_rows {stats['cards_host_rows']}; launches "
          f"{rec['launches']}; peak device bytes {rec['peak_device_bytes']}"
          "; its loads (" + ", ".join(
              f"{k} {v:.2f} s" for k, v in rec["load_secs"].items())
          + f" on {args.threads} threads) by the native readers, their "
          "arrays byte-equal to the draw", flush=True)

    t0 = time.perf_counter()
    cards = bank_mod.host_cards(regs, P)
    cascade = HostCascade(regs, aux, names, cards)
    rng = np.random.default_rng([args.seed, 0xC1])
    probe = rng.integers(0, args.n, size=(PROBE_PAIRS, 2))
    probe = np.concatenate([pairs, probe[probe[:, 0] != probe[:, 1]]])
    rec.update(check_lines(lines, cascade, probe))
    planted = cascade.keys(pairs)
    accepted = cascade.lines(planted)
    printed = {cascade.key_of(*ln.split(" ")[:2]) for ln in lines}
    rec.update(planted_accepted=len(accepted),
               planted_printed=len(printed & set(planted)),
               planted_recall=(len(printed & set(accepted)) / len(accepted)
                               if accepted else None))
    jh = np.array([float(accepted[k].rsplit(" ", 1)[1]) if k in accepted
                   else np.nan for k in planted])
    rec["host_cascade_secs"] = time.perf_counter() - t0
    print(f"  host cascade: every printed line passes with its J string; "
          f"{rec['probe_pairs']} probe pairs (planted and random), "
          f"{rec['probe_accepted']} accepted, printed iff accepted; planted "
          f"{rec['planted_accepted']} accepted of {len(planted)} (targets "
          f"J {targets.min():.3f}-{targets.max():.3f}, accepted host J "
          f"{np.nanmin(jh, initial=np.inf):.6f} and up), recall "
          f"{rec['planted_recall']}; {rec['host_cascade_secs']:.1f} s",
          flush=True)

    rec.update(check_sub(names, regs, aux,
                         sub_rows(args.n, args.sub, pairs, args.seed),
                         args, args.workdir))
    print(f"  sub-collection: {rec['sub_genomes']} genomes, "
          f"{rec['sub_lines']} lines equal to select_pairs_host's (CLI "
          f"{rec['sub_cli_secs']:.2f} s, host {rec['sub_host_secs']:.1f} s)",
          flush=True)

    loaded_here = sorted(set(forbidden_modules(sys.modules)) - preloaded)
    if loaded_here:
        raise CheckFailed(f"the harness loaded {loaded_here}")
    rec["jax_modules"] = {"harness": loaded_here, "child": child_forbidden,
                          "loaded_before_the_run": len(preloaded)}
    rec["host_maxrss_bytes"] = (
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    rec["checks"] = "passed"
    return rec


def main(argv=None):
    """Run the protocol; print its lines and the JSON record, and return
    the record. A failed check raises CheckFailed (exit 1 from the
    command line)."""
    hostmem.enable_arena_reuse()
    ap = argparse.ArgumentParser(
        prog="validate_cli_scale", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=596_859,
                    help="genomes (default: GTDB R220's 596,859)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--planted", type=int, default=256)
    ap.add_argument("-t", dest="threads", type=int, default=8,
                    help="threads of the draw and the CLI's loaders, "
                         "processes of the writer")
    ap.add_argument("--workdir", default=WORKDIR,
                    help="where the sketch files go and stay between calls")
    ap.add_argument("--sub", type=int, default=8192,
                    help="genomes of the sub-collection held to "
                         "select_pairs_host")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    args.workdir = os.path.abspath(args.workdir)
    rec = run(args)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    try:
        main()
    except CheckFailed as exc:
        print(f"validate_cli_scale: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
