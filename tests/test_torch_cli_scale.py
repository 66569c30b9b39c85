"""The selection CLI from sketch files with a real cardinality spread
(cuda_selection_criteria_tpu_torch/experiments/validate_cli_scale.py):
the bank's draw, the port's CLI against the JAX CLI and the host
reference on the same files, the harness end to end on the CPU, its
checker, its work directory and its refusals."""

import os
import types

import numpy as np
import pytest
import torch

from torch_banks import one_torch_thread  # noqa: F401

from cuda_selection_criteria_tpu.cli import selection as jcli
from cuda_selection_criteria_tpu_torch.cli import selection as cli
from cuda_selection_criteria_tpu_torch.experiments import (
    validate_cli_scale as vcs)
from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.models.bank import host_cards
from cuda_selection_criteria_tpu_torch.native import fastx
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    format_results)
from cuda_selection_criteria_tpu_torch.utils import hostref, synth

pytestmark = pytest.mark.usefixtures("one_torch_thread")
N, PLANTED = 512, 16


def draw_args(n=N, seed=0, planted=PLANTED):
    return types.SimpleNamespace(n=n, seed=seed, planted=planted)


@pytest.fixture(scope="module")
def bank():
    """The harness's bank at N=512 with 16 planted pairs."""
    return synth.genome_file_bank(N, 0, PLANTED, threads=4)


@pytest.fixture(scope="module")
def files(bank, tmp_path_factory):
    """The bank's files and list, written by the harness's writer."""
    regs, aux, _, _ = bank
    d = str(tmp_path_factory.mktemp("cli_scale"))
    lst, _ = vcs.write_files(d, regs, aux, 4, vcs.manifest_of(
        draw_args(), regs, aux))
    return lst, vcs.genome_names(d, N)


def test_draw_same_bytes_on_1_and_4_threads(monkeypatch):
    """Each row chunk draws from its own seed child: five chunks of 256
    rows give the same bytes on one thread and on four."""
    monkeypatch.setattr(synth, "GENOME_CHUNK", 256)
    one = synth.genome_file_bank(1100, 7, 8, threads=1)
    four = synth.genome_file_bank(1100, 7, 8, threads=4)
    for a, b in zip(one, four):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert not np.array_equal(one[0],
                              synth.genome_file_bank(1100, 8, 8, 4)[0])


def test_draw_spread_and_planted_jaccard(bank):
    """Cardinalities span 2^20-2^24 (no zero register, so no row takes the
    MLE's log1p branch); the planted pairs' host J lies within 0.03 of
    their targets on average, and their buckets agree in about a share J."""
    regs, aux, pairs, targets = bank
    cards = host_cards(regs, 14)
    lo, hi = np.log2(cards.min()), np.log2(cards.max())
    assert 19.9 < lo < 20.5 and 23.5 < hi < 24.1
    assert (regs > 0).all() and regs.max() <= 51
    e = np.trunc(cards)
    a, b = pairs[:, 0], pairs[:, 1]
    t = hostref.ertl_mle_batch(hostref.pair_union_histograms(regs, a, b), 14)
    j = (e[a] + e[b] - t) / t
    assert np.abs(j - targets).mean() < 0.03
    assert len(np.unique(pairs)) == 2 * PLANTED
    assert ((targets >= 0.8) & (targets < 1.0)).all()
    share = (aux[a] == aux[b]).mean(axis=1)
    assert np.abs(share - targets).mean() < 0.1


def _stdout(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def test_cli_matches_jax_cli_and_host(files, capsys):
    """The port's CLI (--device cpu --engine screened) prints the JAX
    CLI's lines and select_pairs_host's on the same files, as strings."""
    lst, names = files
    argv = ["-l", lst, "-t", "4", "-a", "256", "-h", "0.9", "-c", "smh_a"]
    got = _stdout(cli.main, argv + ["--device", "cpu", "--engine",
                                    "screened"], capsys)
    want = _stdout(jcli.main, argv, capsys)
    assert got == want
    host = SketchBank.from_sketch_files(names, criterion="smh_a")
    assert got.splitlines() == format_results(
        hostref.select_pairs_host(host, 0.9, "smh_a"))
    assert len(got.splitlines()) >= 5


def test_harness_end_to_end_on_cpu(tmp_path):
    """main at N=512 on the CPU: the fresh interpreter's CLI, the load,
    the in-process run and every check pass, and it returns the record."""
    rec = vcs.main(["--n", "512", "--planted", "16", "--sub", "256", "-t",
                    "4", "--device", "cpu", "--workdir", str(tmp_path)])
    assert rec["checks"] == "passed"
    assert rec["lines"] >= 5 and rec["planted_recall"] == 1.0
    assert rec["planted_printed"] == rec["planted_accepted"]
    assert rec["probe_pairs"] > 50_000 and rec["sub_genomes"] == 256
    assert rec["jax_modules"]["harness"] == []
    assert rec["jax_modules"]["child"] == []
    assert set(rec["load_secs"]) == {"hll", "smh32"}
    for key in ("plan_secs", "upload_secs", "cards_secs", "fp_secs",
                "schedule_secs", "prune_secs", "screen_secs",
                "confirm_secs", "format_secs", "cli_wall_secs",
                "write_secs", "bytes_on_disk", "tiles_scheduled",
                "tiles_live", "candidates", "confirmed", "cards_host_rows",
                "host_maxrss_bytes"):
        assert rec[key] is not None, key
    assert rec["cards_host_rows"] == 0
    assert set(rec["launches"]) == {"K1", "G", "H", "M", "F"}


@pytest.fixture(scope="module")
def cascade(bank, files):
    regs, aux, _, _ = bank
    return vcs.HostCascade(regs, aux, files[1], host_cards(regs, 14))


@pytest.fixture(scope="module")
def true_lines(cascade):
    """The cascade's lines over every pair, in the reference's order."""
    i, k = np.triu_indices(N, 1)
    got = cascade.lines(list(zip(i.tolist(), k.tolist())))
    return [got[key] for key in sorted(got)]


def test_checker_passes_the_true_lines(cascade, true_lines, bank):
    counts = vcs.check_lines(true_lines, cascade, bank[2])
    assert counts["probe_accepted"] >= 5


@pytest.mark.parametrize("fault", ["drop_planted", "change_j", "extra",
                                   "swap_order"])
def test_checker_is_not_vacuous(cascade, true_lines, bank, fault):
    """A dropped planted line, a changed J string, a line of a rejected
    pair or two lines swapped: the check raises and names the pair."""
    lines = list(true_lines)
    planted = set(cascade.keys(bank[2]))
    pick = next(n for n, ln in enumerate(lines)
                if cascade.key_of(*ln.split(" ")[:2]) in planted)
    a, b, j = lines[pick].split(" ")
    if fault == "drop_planted":
        del lines[pick]
        named = f"{a} {b}"
    elif fault == "change_j":
        lines[pick] = f"{a} {b} {float(j) + 1e-6:.6f}"
        named = f"{a} {b}"
    elif fault == "extra":
        order = cascade.order
        key = (0, 1)
        assert key not in {cascade.key_of(*ln.split(" ")[:2])
                           for ln in lines}
        named = f"{cascade.names[order[0]]} {cascade.names[order[1]]}"
        lines.insert(0, f"{named} 0.950000")
    else:
        lines[0], lines[1] = lines[1], lines[0]
        named = "order"
    with pytest.raises(vcs.CheckFailed, match=named):
        vcs.check_lines(lines, cascade, bank[2])


def test_workdir_reuse_and_rewrite(tmp_path):
    """A second call with the same draw reuses the files untouched; a
    changed seed rewrites them."""
    d = str(tmp_path)
    regs, aux, _, _ = synth.genome_file_bank(40, 1, 2, threads=2)
    man = vcs.manifest_of(draw_args(40, 1, 2), regs, aux)
    lst, first = vcs.write_files(d, regs, aux, 2, man)
    name = vcs.genome_names(d, 40)[5] + ".hll"
    stamp = os.stat(name).st_mtime_ns
    assert not first["reused"] and first["bytes_on_disk"] > 40 * 7000
    _, again = vcs.write_files(d, regs, aux, 2, man)
    assert again["reused"] and again["bytes_on_disk"] == \
        first["bytes_on_disk"]
    assert os.stat(name).st_mtime_ns == stamp
    regs2, aux2, _, _ = synth.genome_file_bank(40, 2, 2, threads=2)
    _, third = vcs.write_files(d, regs2, aux2, 2, vcs.manifest_of(
        draw_args(40, 2, 2), regs2, aux2))
    assert not third["reused"]
    files = [ln.strip() for ln in open(lst) if ln.strip()]
    back = SketchBank.from_sketch_files(files, criterion="smh_a")
    assert np.array_equal(back.regs, regs2)
    assert np.array_equal(back.aux, aux2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_no_fallback(tmp_path):
    """On cuda without a card the harness stops before it draws."""
    with pytest.raises(SystemExit, match="no CUDA card"):
        vcs.main(["--n", "64", "--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_numpy_reader_load_fails_the_run(files, monkeypatch):
    """A load the numpy readers served (the native library refused) fails
    the run's check."""
    _, names = files
    monkeypatch.setattr(fastx, "available", lambda: False)
    rec = {}
    with vcs.instrumented(rec):
        SketchBank.from_sketch_files(names[:8], criterion="smh_a")
    assert rec["numpy"] == 16 and rec["native"] == 0
    with pytest.raises(vcs.CheckFailed, match="numpy readers"):
        vcs.require_native(rec, "load")


def test_instrumented_keeps_the_loaded_arrays(files):
    """The arrays the run's loads returned are what the harness holds to
    the draw: instrumented keeps each file type's, the bank's own."""
    _, names = files
    rec = {}
    with vcs.instrumented(rec):
        got = SketchBank.from_sketch_files(names[:8], criterion="smh_a")
    assert set(rec["arrays"]) == {"hll", "smh32"}
    assert rec["arrays"]["hll"] is got.regs
    assert rec["arrays"]["smh32"] is got.aux
    assert rec["native"] == 2 and rec["numpy"] == 0
