"""The port's selection CLI against the JAX package's CLI and the host
reference, on planted sketch files written by the port's own writer."""

import os
import subprocess
import sys

import numpy as np
import pytest

from cuda_selection_criteria_tpu.cli import selection as jcli
from cuda_selection_criteria_tpu_torch.cli import selection as cli
from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    format_results)
from cuda_selection_criteria_tpu_torch.utils import formats, synth
from cuda_selection_criteria_tpu_torch.utils.hostref import select_pairs_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sketch_list(tmp_path_factory):
    """24 genomes at p=14 and m=32 in two size classes (so CB prunes),
    with near-duplicate pairs planted; returns the file-list path."""
    d = tmp_path_factory.mktemp("sketches")
    rng = np.random.default_rng(2048)
    regs = np.concatenate([synth.synthetic_regs(12, 1500, 14, rng),
                           synth.synthetic_regs(12, 3000, 14, rng)])
    aux = synth.synthetic_aux(24, 32, rng)
    synth.plant_near_duplicates(regs, aux, rng, 5)
    names = [str(d / f"g{i:02d}.fna.gz") for i in range(24)]
    for name, r, a in zip(names, regs, aux):
        formats.write_hll(name + ".hll", 14, r)
        formats.write_smh(name + ".smh32", a)
    lst = d / "list.txt"
    lst.write_text("\n".join(names) + "\n")
    return str(lst)


def _stdout(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("crit", ["smh_a", "cb", "baseline"])
def test_cli_output_matches_jax_and_host(sketch_list, crit, capsys):
    argv = ["-l", sketch_list, "-a", "256", "-h", "0.9", "-c", crit]
    got = _stdout(cli.main, argv + ["--device", "cpu"], capsys)
    want = _stdout(jcli.main, argv, capsys)
    assert got == want
    files = [ln.strip() for ln in open(sketch_list) if ln.strip()]
    bank = SketchBank.from_sketch_files(
        files, criterion="smh_a" if crit == "smh_a" else None)
    host = select_pairs_host(bank, 0.9, crit, apply_cb=(crit != "baseline"))
    assert got.splitlines() == format_results(host)
    assert len(host) >= 3
    # the screened engine with an explicit tile prints the same lines
    assert _stdout(cli.main, argv + ["--device", "cpu", "--engine",
                                     "screened", "-b", "64"], capsys) == got


def test_cli_messages_match_jax(capsys):
    for argv in (["-x"], ["-c", "nope"], ["-b", "0", "-c", "smh_a"]):
        assert _stdout(cli.main, argv, capsys) == \
            _stdout(jcli.main, argv, capsys)
    for crit in ("hll_a", "hll_an", "smh_only"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main(["-l", "unused", "-c", crit])


def test_import_leaves_jax_out():
    """The port never imports JAX (the machine with the card has none);
    checked in a fresh interpreter, since this one already imported it."""
    mods = ["cuda_selection_criteria_tpu_torch"] + [
        f"cuda_selection_criteria_tpu_torch.{m}" for m in (
            "cli.selection", "models.bank", "ops._build", "ops.criteria",
            "ops.estimators", "ops.screen", "parallel.scheduler",
            "parallel.screened", "parallel.selection", "utils.device",
            "utils.filelist", "utils.formats", "utils.hostref",
            "utils.synth")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'cuda_selection_criteria_tpu.'))"
            " or m == 'cuda_selection_criteria_tpu']\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
