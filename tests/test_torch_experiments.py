"""The port's experiment protocols (cuda_selection_criteria_tpu_torch/
experiments) against the JAX package's scripts (experiments/*.py) on the
same inputs, on the CPU: the differential's rows, the timing sweep's row
set and the confirm stage's outputs."""

import csv
import gzip
import importlib.util
import os
import sys

import numpy as np
import pytest

from torch_banks import one_torch_thread  # noqa: F401

from cuda_selection_criteria_tpu.utils import hostref as jhostref
from cuda_selection_criteria_tpu_torch.cli import build_sketch as build_cli
from cuda_selection_criteria_tpu_torch.experiments import (
    compare_engines, confirm_throughput, run_time_experiment)
from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)
from cuda_selection_criteria_tpu_torch.utils import formats, synth
from cuda_selection_criteria_tpu_torch.utils.hostref import select_pairs_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_script(name):
    """experiments/<name>.py of the JAX package, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(mod, argv, monkeypatch):
    """The JAX scripts' main() reads sys.argv."""
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    return mod.main()


def _rows(path, delimiter=","):
    with open(path, newline="") as fh:
        return list(csv.reader(fh, delimiter=delimiter))


@pytest.fixture(scope="module")
def sketch_list(tmp_path_factory):
    """48 genomes of 256 to 32768 hashes (so CB prunes at tau 0.3) with
    .hll, .smh32 and .hll_8 files and 6 planted near-duplicate pairs,
    written by the port's writers; returns the file-list path."""
    d = tmp_path_factory.mktemp("sketches")
    rng = np.random.default_rng(2048)
    n = 48
    items = np.exp(rng.uniform(np.log(256), np.log(32768), n)).astype(
        np.int64)
    regs, hll = synth.synthetic_hll_banks(n, items, (14, 8), rng)
    aux = synth.synthetic_aux(n, 32, rng)
    for i in synth.plant_near_duplicates(regs, aux, rng, 6):
        hll[i + 1] = hll[i]
    names = [str(d / f"g{i:03d}.fna.gz") for i in range(n)]
    for name, r, a, h in zip(names, regs, aux, hll):
        formats.write_hll(name + ".hll", 14, r)
        formats.write_smh(name + ".smh32", a)
        formats.write_hll(name + ".hll_8", 8, h)
    lst = d / "list.txt"
    lst.write_text("\n".join(names) + "\n")
    return str(lst)


@pytest.mark.parametrize("tau", ["0.01", "0.3"])
@pytest.mark.parametrize("crit", ["smh_a", "hll_a", "baseline"])
def test_compare_engines_matches_jax(sketch_list, crit, tau, tmp_path,
                                     capsys, monkeypatch):
    """The port's differential writes the JAX script's pair keys and
    similarity strings with 0 mismatches, and --estimator-delta prints the
    same statistics."""
    argv = ["-l", sketch_list, "-a", "256", "-t", tau, "-c", crit,
            "--estimator-delta"]
    port_csv, jax_csv = tmp_path / "port.csv", tmp_path / "jax.csv"
    capsys.readouterr()
    assert compare_engines.main(argv + ["-o", str(port_csv), "--device",
                                        "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert _run_jax_main(_jax_script("compare_engines"),
                         argv + ["-o", str(jax_csv)], monkeypatch) == 0
    want = capsys.readouterr().out.splitlines()
    rows, jrows = _rows(port_csv, ";"), _rows(jax_csv, ";")
    assert rows[0] == ["par", "sim_cpu", "sim_host", "delta", "ok"]
    assert jrows[0][1] == "sim_tpu"
    assert rows[1:] == jrows[1:]
    assert all(r[4] == "OK" and r[3] == "0.00e+00" for r in rows[1:])
    assert len(rows) - 1 >= 6  # the planted pairs at least
    assert got[0].split(" -> ")[0] == want[0].split(" -> ")[0]
    assert got[1:] == want[1:]
    assert got[1].startswith("estimator-delta")


@pytest.mark.parametrize("crit", ["smh_a", "hll_a", "hll_an", "cb",
                                  "baseline", "smh_only"])
def test_compare_engines_screened_engine_at_low_tau(sketch_list, crit):
    """The screened engine (the card's `auto`) on the CPU at tau=0.01: the
    certified screen, the reject bound and the hll-aux coefficient at a low
    threshold keep every pair the scalar host engine emits."""
    files = [ln.strip() for ln in open(sketch_list) if ln.strip()]
    bank = compare_engines.load_bank(files, crit, 256)
    dev, host = compare_engines.run_both(bank, SelectionParams(
        tau=0.01, criterion=crit, engine="screened"), "cpu")
    rows, n_bad = compare_engines.compare_rows(dev, host)
    assert n_bad == 0
    assert len(rows) >= 6


def test_compare_engines_host_cb_follows_the_criterion():
    """The host side applies CB exactly when the criterion does: a baseline
    pair whose cardinality ratio is below tau but whose Jaccard is above it
    is emitted by both sides (the JAX script's host side, CB on for every
    criterion, drops it and reports it MISSING)."""
    rng = np.random.default_rng(5)
    regs = synth.synthetic_regs(3, 4000, 14, rng)
    regs[1] = regs[0]
    t = SketchBank(names=["a"], regs=regs[:1]).cards[0]
    # the union of rows 0 and 1 is row 0: J = (e0 + e1 - t) / t
    bank = SketchBank(names=["a", "b", "c"], regs=regs,
                      cards=np.array([0.009 * 1.2 * t, 1.2 * t, 3.0 * t]))
    dev, host = compare_engines.run_both(bank, SelectionParams(
        tau=0.01, criterion="baseline"), "cpu")
    rows, n_bad = compare_engines.compare_rows(dev, host)
    assert n_bad == 0
    assert ("a", "b") in {(a, b) for a, b, _ in host}
    assert ("a", "b") not in {(a, b) for a, b, _ in select_pairs_host(
        bank, 0.01, "baseline", apply_cb=True)}


def _write_fasta_corpus(d):
    """Four gz FASTA genomes: two of 6000 bases differing by 5 SNPs, two
    unrelated of 4000 and 9000 bases."""
    rng = np.random.default_rng(31)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, 6000)]
    snp = base.copy()
    idx = rng.integers(0, snp.size, 5)
    snp[idx] = acgt[(np.searchsorted(acgt, snp[idx]) + 1) % 4]
    seqs = [base, snp, acgt[rng.integers(0, 4, 4000)],
            acgt[rng.integers(0, 4, 9000)]]
    files = []
    for g, seq in enumerate(seqs):
        path = os.path.join(d, f"g{g}.fna.gz")
        text = b">chr%d\n" % g + b"".join(
            seq[i:i + 70].tobytes() + b"\n" for i in range(0, seq.size, 70))
        with gzip.open(path, "wb") as fh:
            fh.write(text)
        files.append(path)
    lst = os.path.join(d, "list.txt")
    with open(lst, "w") as fh:
        fh.write("\n".join(files) + "\n")
    assert build_cli.main(["-l", lst, "-a", "256", "-c", "smh_a",
                           "--device", "cpu"]) == 0
    return lst


def test_run_time_experiment_rows_match_jax(tmp_path, capsys, monkeypatch):
    """The header and, in each arm, the multiset of (block, mh_size, rep,
    criterio) equal the JAX script's, arm labels mapped; every time is
    positive."""
    lst = _write_fasta_corpus(str(tmp_path))
    argv = ["-l", lst, "--threshold", "0.5", "--mh-sizes", "8", "16",
            "--blocks", "64", "128", "--reps", "1"]
    port_csv, jax_csv = tmp_path / "port.csv", tmp_path / "jax.csv"
    assert run_time_experiment.main(argv + ["-o", str(port_csv), "--device",
                                            "cpu"]) == 0
    _run_jax_main(_jax_script("run_time_experiment"),
                  argv + ["-o", str(jax_csv)], monkeypatch)
    rows, jrows = _rows(port_csv), _rows(jax_csv)
    assert rows[0] == jrows[0] == run_time_experiment.HEADER
    labels = {"cpu-xla": "cpu-torch", "tpu": "cuda", "host": "host"}

    def arms(table, mapping):
        out = {}
        for impl, block, m, rep, crit, secs in table[1:]:
            assert float(secs) > 0.0
            out.setdefault(mapping.get(impl, impl), []).append(
                (block, m, rep, crit))
        return {k: sorted(v) for k, v in out.items()}

    got, want = arms(rows, {}), arms(jrows, labels)
    assert got == want
    assert set(got) == {"cpu-torch", "host"}
    assert len(got["cpu-torch"]) == 2 * 2 * 5
    assert len(got["host"]) == 2 * 3
    assert "Listo" in capsys.readouterr().out


def _jax_confirm(bank, pairs, tau):
    """The JAX package's PairOracle over sorted-position pairs of `bank`
    (baseline, no CB), host histograms."""
    order = bank.sorted_by_cardinality()
    oracle = jhostref.PairOracle(bank.p, bank.regs[order],
                                 np.trunc(bank.cards[order]),
                                 criterion="baseline", tau=tau,
                                 apply_cb=False)
    return oracle.confirm_pairs(pairs)


def test_confirm_throughput_matches_jax_oracle():
    """Default protocol at N=256 with 4096 pairs: the port's host outputs
    and its device-path outputs (CPU tensors) both equal the JAX
    PairOracle's on the same arrays."""
    bank, rng = confirm_throughput.random_bank(256)
    ii, kk = confirm_throughput.random_pairs(256, 4096, rng)
    res, host_out, dev_out = confirm_throughput.confirm_rates(
        bank, ii, kk, "cpu", reps=1, chunk=512, batch=1024)
    want = _jax_confirm(bank, list(zip(ii.tolist(), kk.tolist())), -100.0)
    assert host_out == want
    assert dev_out == want
    assert len(want) == 4096  # tau=-100: every pair is emitted
    assert res["n_pairs"] == 4096 and res["device"] == "cpu"
    assert res["host_confirm_pairs_per_sec"] > 0
    assert res["device_assisted_confirm_pairs_per_sec"] > 0
    res, host_only, none = confirm_throughput.confirm_rates(
        bank, ii, kk, "cpu", reps=1, host_only=True)
    assert host_only == want and none is None and res["n_pairs"] == 1024


def test_confirm_throughput_reject_protocol():
    """--reject at N=256 with 4096 pairs: the reject bound on and off give
    the same output, the JAX PairOracle's; the random pairs are rejected
    and the planted ones emitted (but those whose row a later pick
    overwrote: picks may be neighbours, as in the JAX script)."""
    rng = np.random.default_rng(9)
    bank, picks = confirm_throughput.reject_bank(256, rng)
    assert len(picks) == 64
    lo, hi = confirm_throughput.reject_pairs(bank, picks, 4096, rng)
    assert (lo < hi).all()
    res, out = confirm_throughput.reject_rates(bank, lo, hi, "cpu", reps=1,
                                               chunk=512, batch=1024)
    assert out == _jax_confirm(bank, list(zip(lo.tolist(), hi.tolist())),
                               0.9)
    n_dup = 4096 // 10
    assert 0.8 * n_dup <= res["pairs_emitted"] == len(out) <= n_dup
    # the bound never rejects an emitted pair
    assert 0.9 <= res["reject_fraction"] <= round(1.0 - len(out) / 4096, 4)
    assert res["device_reject_on_pairs_per_sec"] > 0


def test_experiment_mains_print_one_result(tmp_path, capsys):
    """The confirm harness's main prints one JSON line with the JAX
    script's keys and the torch device in place of the backend."""
    import json

    assert confirm_throughput.main(["--n", "64", "--pairs", "256", "--reps",
                                    "1", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"n_pairs", "device", "native_hist",
                        "host_confirm_pairs_per_sec",
                        "device_assisted_confirm_pairs_per_sec"}
    assert confirm_throughput.main(["--n", "64", "--pairs", "256", "--reps",
                                    "1", "--reject", "--device",
                                    "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["protocol"] == "reject_workload" and res["device"] == "cpu"
