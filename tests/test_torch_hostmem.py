"""utils/hostmem, the port's copy of the JAX package's arena reuse, and
where the port calls it: every entry point (the three CLIs' main, the
experiments' main, chip_smoke.main) and nothing at import.

Importing the JAX package turns reuse on for the whole process
(cuda_selection_criteria_tpu/__init__.py), and this suite imports it in
the same workers, so every case runs in a fresh interpreter that imports
only the port (or, for the JAX module's own return value, that module's
file alone), with a timeout of its own."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from test_torch_build_bank import built_list, corpus  # noqa: F401
from test_torch_cli import sketch_list  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HOSTMEM = os.path.join(ROOT, "cuda_selection_criteria_tpu", "utils",
                           "hostmem.py")
PORT = "cuda_selection_criteria_tpu_torch"
CLIS = ("selection", "build_sketch", "time_smh")
EXPERIMENTS = ("bench", "compare_engines", "confirm_thread_sweep",
               "confirm_throughput", "hist_split", "kernel_tuning",
               "mle_split", "run_time_experiment", "scale_sweep",
               "unpack_split", "validate_131k_scale", "validate_cli_scale",
               "validate_hllaux", "validate_ring_scale", "validate_screened")
TIMEOUT = 60

# a recorder in place of enable_arena_reuse (monkeypatch), calling through
RECORDER = """
import json, sys
import pytest
from cuda_selection_criteria_tpu_torch.utils import hostmem
calls = []
real = hostmem.enable_arena_reuse


def recorder(*args, **kw):
    calls.append(kw or list(args))
    return real(*args, **kw)


mp = pytest.MonkeyPatch()
mp.setattr(hostmem, "enable_arena_reuse", recorder)
"""


def run(code, *args):
    """Run `code` in a fresh interpreter from the repo root: the JSON of
    its last line of stdout."""
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_imports_leave_the_allocator_alone():
    """Importing the port, its CLIs and its experiments calls nothing."""
    mods = [PORT] + [f"{PORT}.cli.{c}" for c in CLIS] + [
        f"{PORT}.experiments.{e}" for e in EXPERIMENTS + ("hostmem_split",)]
    out = run(f"""
import importlib, json, sys
for m in {mods!r}:
    importlib.import_module(m)
from cuda_selection_criteria_tpu_torch.utils import hostmem
print(json.dumps({{"enabled": hostmem._enabled,
                  "jax": [m for m in sys.modules if m == "jax"
                          or m.split(".")[0] == "cuda_selection_criteria_tpu"]
                  }}))
""")
    assert out == {"enabled": None, "jax": []}


@pytest.mark.parametrize("cli", CLIS)
def test_cli_main_calls_it_once(cli, sketch_list, built_list,  # noqa: F811
                                corpus, tmp_path):  # noqa: F811
    """Each CLI's main, run on the CLI tests' tiny banks with --device cpu,
    calls enable_arena_reuse exactly once, and it takes effect."""
    if cli == "selection":
        argv = ["-l", sketch_list, "-a", "256", "-h", "0.9", "-c", "smh_a",
                "--device", "cpu"]
    elif cli == "time_smh":
        argv = ["-l", built_list[0], "-m", "16", "-h", "0.5", "-R", "1",
                "-t", "2", "--device", "cpu"]
    else:
        files = []
        for f in corpus:
            files.append(str(tmp_path / os.path.basename(f)))
            shutil.copyfile(f, files[-1])
        (tmp_path / "list.txt").write_text("\n".join(files) + "\n")
        argv = ["-l", str(tmp_path / "list.txt"), "-a", "32", "-c", "smh_a",
                "--backend", "device", "--device", "cpu"]
    out = run(RECORDER + f"""
from cuda_selection_criteria_tpu_torch.cli import {cli}
rc = {cli}.main(json.loads(sys.argv[1]))
print(json.dumps({{"rc": rc, "calls": calls,
                  "enabled": hostmem._enabled}}))
""", json.dumps(argv))
    assert out["rc"] == 0
    assert out["calls"] == [[]]
    assert out["enabled"] is not None


def test_experiment_and_smoke_mains_call_it_first():
    """Each of the 15 experiments' main calls it before it parses its
    arguments (--help exits in the parser), and chip_smoke.main before
    it finds no card (it returns 1 here)."""
    out = run(RECORDER + f"""
import contextlib, importlib, io
seen = []
for name in {EXPERIMENTS!r}:
    mod = importlib.import_module("cuda_selection_criteria_tpu_torch."
                                  "experiments." + name)
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            mod.main(["--help"])
        except SystemExit:
            pass
    seen.append(len(calls))
import chip_smoke
with contextlib.redirect_stderr(io.StringIO()):
    rc = chip_smoke.main()
print(json.dumps({{"seen": seen, "smoke": [rc, len(calls)]}}))
""")
    assert out["seen"] == list(range(1, len(EXPERIMENTS) + 1))
    assert out["smoke"] == [1, len(EXPERIMENTS) + 1]


def test_return_value_and_constants_match_jax():
    """The port's first call returns what the JAX module's own first call
    returns on this host (that module loaded from its file alone: the JAX
    package's import would call it first), with the same constants and
    default threshold."""
    probe = """
import importlib.util, inspect, json, sys
spec = importlib.util.spec_from_file_location("hm", sys.argv[1])
hm = importlib.util.module_from_spec(spec)
spec.loader.exec_module(hm)
assert hm._enabled is None
print(json.dumps({"ret": hm.enable_arena_reuse(), "latched": hm._enabled,
                  "consts": [hm._M_TRIM_THRESHOLD, hm._M_MMAP_THRESHOLD],
                  "default": inspect.signature(hm.enable_arena_reuse)
                  .parameters["threshold_bytes"].default}))
"""
    port = run(probe, os.path.join(ROOT, PORT, "utils", "hostmem.py"))
    jax = run(probe, JAX_HOSTMEM)
    assert port == jax
    assert port["consts"] == [-1, -3] and port["default"] == 1 << 30
    assert port["ret"] is port["latched"] is not None


@pytest.mark.parametrize("libc", ["glibc", "oserror", "no_mallopt"])
def test_second_call_is_latched(libc):
    """The first call's result is latched for the process: a second call
    (another threshold too) returns it without touching libc. A libc that
    cannot load, or has no mallopt, gives False, latched the same way."""
    out = run(f"""
import ctypes, json
from cuda_selection_criteria_tpu_torch.utils import hostmem
real = ctypes.CDLL
mode = {libc!r}


def fake(*a, **kw):
    if mode == "oserror":
        raise OSError("no libc")
    return object()


if mode != "glibc":
    hostmem.ctypes.CDLL = fake
first = hostmem.enable_arena_reuse()


def refuse(*a, **kw):
    raise AssertionError("libc loaded again")


hostmem.ctypes.CDLL = refuse
second = hostmem.enable_arena_reuse(threshold_bytes=1 << 20)
hostmem.ctypes.CDLL = real
print(json.dumps([first, second, hostmem._enabled]))
""")
    first, second, latched = out
    assert first is second is latched
    if libc == "glibc":
        assert first is not None
    else:
        assert first is False


EFFECT = """
import json, resource, sys
import numpy as np
from cuda_selection_criteria_tpu_torch.utils import hostmem
on = sys.argv[1] == "on"
ret = hostmem.enable_arena_reuse() if on else None


def touch():
    f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
    a = np.empty(256 << 20, np.uint8)
    a.fill(1)
    f1 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
    del a
    return f1 - f0


print(json.dumps({"ret": ret, "faults": [touch(), touch()]}))
"""


@pytest.mark.parametrize("reuse", ["on", "off"])
def test_effect_on_a_freed_256_mib_array(reuse):
    """With reuse on, a second 256 MiB array takes the freed one's pages
    (at most 10% of the first touch's minor faults); with reuse off it is
    a fresh mapping (at least 50%). Transparent huge pages may fold the
    faults below what can be told apart: then the case skips."""
    out = run(EFFECT, reuse)
    if reuse == "on" and out["ret"] is not True:
        pytest.skip(f"enable_arena_reuse() returned {out['ret']} here")
    first, second = out["faults"]
    if first < 64:
        pytest.skip(f"first touch counted {first} minor faults (second "
                    f"{second}): too few to compare")
    if reuse == "on":
        assert second <= 0.1 * first, out
    else:
        assert second >= 0.5 * first, out
