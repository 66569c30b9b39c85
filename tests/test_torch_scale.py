"""The port's at-scale validation harnesses (cuda_selection_criteria_tpu_torch/
experiments/validate_*.py, confirm_thread_sweep.py) against the JAX
package's scripts (experiments/*.py, bench.py) on the same inputs, on the
CPU at small sizes. Every comparison is bit-equality: banks, cardinalities,
tile lists and pair lists (Jaccards to 12 digits where a list is compared
with another engine's)."""

import csv
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from cuda_selection_criteria_tpu.models.bank import SketchBank as JaxBank
from cuda_selection_criteria_tpu.parallel.screened import (
    ScreenPlan as JaxPlan)
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JaxParams)
from cuda_selection_criteria_tpu.utils import hostref as jhostref
from cuda_selection_criteria_tpu_torch.experiments import (
    confirm_thread_sweep, validate_131k_scale, validate_hllaux,
    validate_ring_scale, validate_screened)
from cuda_selection_criteria_tpu_torch.native import fastx
from cuda_selection_criteria_tpu_torch.parallel.mesh import row_mesh
from cuda_selection_criteria_tpu_torch.parallel.screened import ScreenPlan
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)
from cuda_selection_criteria_tpu_torch.utils import hostref, synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N = 1024  # the planted bench bank's size here
TI = 64   # 136 tiles at N
STAGES = ("plan_secs", "upload_secs", "schedule_secs", "gate_warmup_secs",
          "prune_secs", "screen_warmup_secs", "screen_secs", "confirm_secs")
WARMUPS = ("gate_warmup_secs", "screen_warmup_secs")
GATE_STATS = ("gate_chunks", "gate_first_dispatch_secs",
              "gate_dispatch_secs", "gate_fetch_secs")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread_module():
    """One torch intra-op thread for the whole module, its module-scoped
    banks and runs included (torch_banks.one_torch_thread is per test, so
    it would leave those to a thread per core in every worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name):
    """experiments/<name>.py of the JAX package, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH_CACHE = "csc_bench_bank_v3_"  # bench.build_synthetic_bank's npz cache


@pytest.fixture
def jax_bench_bank(monkeypatch):
    """bench.build_synthetic_bank with its npz cache bypassed: the cache
    never looks present and is never written, so each call (the JAX
    planted_bank's too) builds the bank itself and no file is read,
    written or removed."""
    import bench

    def ours(path):
        return os.path.basename(os.fspath(path)).startswith(BENCH_CACHE)

    exists, savez, replace = os.path.exists, np.savez, os.replace
    monkeypatch.setattr(os.path, "exists",
                        lambda path: not ours(path) and exists(path))
    monkeypatch.setattr(np, "savez", lambda path, *a, **kw: (
        None if ours(path) else savez(path, *a, **kw)))
    monkeypatch.setattr(os, "replace", lambda src, dst, **kw: (
        None if ours(src) else replace(src, dst, **kw)))
    return bench.build_synthetic_bank


def _params():
    return SelectionParams(tau=0.9, criterion="smh_a",
                           aux_bytes=8 * synth.BENCH_M)


@pytest.fixture(scope="module")
def planted():
    """(bank, picks) of the scale harnesses' planted bench bank at N."""
    bank, picks, _ = validate_131k_scale.make_bank(N)
    return bank, picks


@pytest.fixture(scope="module")
def screened_run(planted):
    """validate_131k_scale.run on the planted bank, on the CPU."""
    return validate_131k_scale.run(planted[0], _params(), ti=TI, chunk=16,
                                   device="cpu")


def _jax_oracle(bank):
    """The JAX package's exact oracle over the bank's sorted rows, and each
    bank row's sorted position."""
    order = np.argsort(bank.cards, kind="stable")
    pos = np.empty_like(order)
    pos[order] = np.arange(len(order))
    oracle = jhostref.PairOracle(
        bank.p, bank.regs[order], np.trunc(bank.cards[order]),
        aux=bank.aux[order], aux_param=bank.aux_param, criterion="smh_a",
        tau=0.9)
    return oracle, pos


def _check_pairs(bank, picks, pairs):
    """Every emitted pair is confirmed by the JAX oracle with the identical
    Jaccard; every planted pair that the oracle passes is emitted."""
    oracle, pos = _jax_oracle(bank)
    row = {name: i for i, name in enumerate(bank.names)}
    emitted = set()
    for a, b, j in pairs:
        sel, j_exact = oracle.evaluate(*sorted((pos[row[a]], pos[row[b]])))
        assert sel and j == j_exact, (a, b)
        emitted.add((row[a], row[b]))
    n_pass = 0
    for i in picks:
        lo, hi = sorted((pos[i], pos[i + 1]))
        if oracle.evaluate(lo, hi)[0]:
            n_pass += 1
            a, b = sorted((i, i + 1), key=lambda r: pos[r])
            assert (a, b) in emitted, (i, i + 1)
    assert n_pass > 0


@pytest.mark.parametrize("n", [512, 1024])
def test_bench_bank_matches_jax(n, jax_bench_bank):
    """synth.bench_bank draws the reference bench's bank: regs, SMH
    buckets and cardinalities bit-equal."""
    got = synth.bench_bank(n)
    want = jax_bench_bank(n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_reduce_hashes_rank_is_the_scalar_rule():
    """The registers' rank is clz(((h << 1) | 1) << (p - 1)) + 1 of the
    reference's rule, on hashes with every bit length, at every p the port
    builds."""
    one = np.uint64(1)
    bits = np.arange(64, dtype=np.uint64)
    h = np.concatenate([one << bits, (one << bits) - one, ~(one << bits),
                        np.random.default_rng(3).integers(
                            0, 1 << 64, 256, dtype=np.uint64)])[None, :]
    for p in (4, 8, 10, 14, 16):
        regs = synth._reduce_hashes(h, np.ones(h.shape, bool), p)
        want = np.zeros(1 << p, np.uint8)
        for x in h[0].tolist():
            v = ((((x << 1) | 1) << (p - 1)) & (2**64 - 1))
            rank = 64 - v.bit_length() + 1
            idx = x >> (64 - p)
            want[idx] = max(want[idx], rank)
        assert np.array_equal(regs[0], want), p


def test_planted_bank_matches_jax(jax_bench_bank):
    """planted_bank plants in the reference's draw order: regs, aux, e and
    the count equal to the JAX harness's planted_bank (which builds its
    bench bank itself, the cache bypassed by the fixture)."""
    jmod = _jax_script("validate_131k_scale")
    want = jmod.planted_bank(N, np.random.default_rng(0x131))
    got = validate_131k_scale.planted_bank(N, np.random.default_rng(0x131))
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[3]) == want[3] == 128


def test_planted_bank_order_matters():
    """Planting the same draws in sorted order (synth.plant_near_duplicates)
    gives another bank at this density, so the harness keeps its own
    loop."""
    regs, aux, _, _ = validate_131k_scale.planted_bank(
        N, np.random.default_rng(0x131))
    r2, a2, _ = synth.bench_bank(N)
    synth.plant_near_duplicates(r2, a2, np.random.default_rng(0x131), 128)
    assert not np.array_equal(regs, r2)


def test_screened_run_stages(screened_run):
    record, pairs = screened_run
    for key in STAGES + GATE_STATS:
        assert record[key] >= 0, key
    assert record["total_secs"] == pytest.approx(
        sum(record[k] for k in STAGES if k not in WARMUPS))
    assert record["total_with_warmup_secs"] == pytest.approx(
        sum(record[k] for k in STAGES))
    assert record["tiles_scheduled"] == 136
    assert 0 < record["tiles_live"] < record["tiles_scheduled"]
    assert record["gate_chunks"] == math.ceil(136 / 256)
    assert record["pairs_emitted"] == len(pairs) <= record["candidates"]
    assert record["device"] == "cpu" and record["peak_allocated_bytes"] is None
    assert record["k1_launches"] == 0  # the plain version counts nothing


def test_screened_run_pairs_confirmed(planted, screened_run):
    bank, picks = planted
    _check_pairs(bank, picks, screened_run[1])


def test_validate_131k_scale_main(capsys):
    """The CLI at a small n and tile: its last line is the JSON record with
    every stage key and the planted pairs recovered."""
    rc = validate_131k_scale.main(["--n", "512", "--ti", "64", "--chunk",
                                   "8", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert rec["planted_recovered"] is True
    assert rec["pairs_emitted"] >= rec["planted_dups"] == 128
    assert rec["min_jacc"] > 0.9
    for key in STAGES + GATE_STATS + (
            "tiles_scheduled", "tiles_live", "candidates", "total_secs",
            "total_with_warmup_secs", "triangle_pairs_per_sec",
            "resident_secs", "resident_pairs_per_sec",
            "peak_allocated_bytes", "device_total_bytes", "bank_secs",
            "host_peak_rss_bytes", "host_total_bytes"):
        assert key in rec, key


def test_planted_check():
    pairs = [("a", "b", 0.95), ("c", "d", 0.99)]
    assert validate_131k_scale.planted_check(pairs, 2)["planted_recovered"]
    assert not validate_131k_scale.planted_check(pairs, 3)[
        "planted_recovered"]
    low = pairs + [("e", "f", 0.9)]
    assert not validate_131k_scale.planted_check(low, 2)["planted_recovered"]
    assert validate_131k_scale.planted_check([], 0)["min_jacc"] is None


@pytest.mark.parametrize("n_dev", [1, 4])
def test_ring_scale_matches_screened(planted, screened_run, n_dev):
    """validate_ring_scale.run on a CPU mesh of 1 and 4 devices gives the
    screened harness's pairs."""
    record, pairs = validate_ring_scale.run(
        planted[0], _params(), mesh=row_mesh(["cpu"] * n_dev), ti=TI,
        device="cpu")
    assert pairs == screened_run[1]
    assert record["engine"] == "ring"
    assert record["steps_total"] == n_dev
    assert record["pairs_emitted"] == len(pairs)
    assert record["k1_launches"] == record["k1_strip_launches"] == 0


def test_prune_tiles_stats_match_jax(planted):
    """prune_tiles keeps the same tiles with and without stats, fills the
    JAX plan's keys, and keeps the JAX plan's tiles."""
    bank = planted[0]
    plan = ScreenPlan(bank, _params(), TI, device="cpu")
    rows, cols = plan.schedule()
    plain = plan.prune_tiles(rows, cols, chunk=32)
    stats = {}
    got = plan.prune_tiles(rows, cols, chunk=32, stats=stats)
    assert all(np.array_equal(a, b) for a, b in zip(plain, got))
    assert stats["gate_chunks"] == math.ceil(len(rows) / 32)

    jplan = JaxPlan(JaxBank(names=bank.names, regs=bank.regs, p=bank.p,
                            cards=bank.cards, aux_kind="smh", aux=bank.aux,
                            aux_param=bank.aux_param),
                    JaxParams(tau=0.9, criterion="smh_a"), TI)
    jrows, jcols = jplan.schedule()
    assert np.array_equal(jrows, rows) and np.array_equal(jcols, cols)
    jstats = {}
    want = jplan.prune_tiles(jrows, jcols, chunk=256, stats=jstats)
    assert set(jstats) == set(stats) == set(GATE_STATS)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))


SMALL = 96  # planted-cluster banks here: every cluster (about 70 genomes)


@pytest.fixture(scope="module")
def jax_planted_cluster_bank():
    return _jax_script("validate_screened_tpu").build_planted_bank(SMALL)


def _same_bank(got, want):
    assert got.names == list(want.names)
    for field in ("regs", "aux", "cards"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and np.array_equal(g, w), field
    assert (got.p, got.aux_kind, got.aux_param) == (
        want.p, want.aux_kind, want.aux_param)


def _rounded(pairs):
    return [(a, b, round(j, 12)) for a, b, j in pairs]


def test_build_planted_bank_matches_jax(jax_planted_cluster_bank):
    _same_bank(validate_screened.build_planted_bank(SMALL, device="cpu"),
               jax_planted_cluster_bank)


@pytest.mark.parametrize("crit", ["smh_a", "cb"])
def test_validate_screened_pairs_match_jax_host(crit,
                                                jax_planted_cluster_bank):
    """The differential's screened pairs equal the JAX select_pairs_host's
    on the JAX bank."""
    bank = validate_screened.build_planted_bank(SMALL, device="cpu")
    ok, got, _, _, _ = validate_screened.differential(
        bank, SelectionParams(tau=0.8, criterion=crit), "cpu")
    want = jhostref.select_pairs_host(jax_planted_cluster_bank, 0.8, crit)
    assert ok and len(want) >= 24
    assert _rounded(got) == _rounded(want)


def test_validate_screened_main(capsys):
    assert validate_screened.main(["-n", str(SMALL), "--device", "cpu"]) == 0
    assert "EXACT MATCH" in capsys.readouterr().out


def test_validate_screened_main_reports_mismatch(monkeypatch, capsys):
    """A screened engine that drops a pair makes main return 1 and print
    the missing pair."""
    real = validate_screened.select_pairs_screened
    monkeypatch.setattr(validate_screened, "select_pairs_screened",
                        lambda *a, **kw: real(*a, **kw)[1:])
    assert validate_screened.main(["-n", str(SMALL), "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "MISMATCH: missing=1 extra=0" in out and "missing: (" in out


def _jax_hll_bank(n):
    """The bank of the JAX experiments/validate_hllaux_tpu.py (lines
    17-37), which does its work at module level: the same draws and the
    JAX package's HLL build at p=14 and p_aux=8, 256 genomes a batch."""
    import jax.numpy as jnp
    from cuda_selection_criteria_tpu.ops import hll_build

    rng = np.random.default_rng(11)
    items, p, p_aux = 4096, 14, 8
    genomes = []
    for _ in range(24):
        base = rng.integers(0, 1 << 63, items, np.uint64)
        for _ in range(int(rng.integers(2, 5))):
            g = base.copy()
            idx = rng.choice(items, size=int(0.04 * items), replace=False)
            g[idx] = rng.integers(0, 1 << 63, idx.size, np.uint64)
            genomes.append(g)
    while len(genomes) < n:
        genomes.append(rng.integers(0, 1 << 63, items, np.uint64))
    genomes = genomes[:n]
    regs_l, aux_l = [], []
    for b0 in range(0, n, 256):
        chunk = genomes[b0:b0 + 256]
        kms = jnp.asarray(np.concatenate(chunk))
        gids = jnp.asarray(np.repeat(np.arange(len(chunk), dtype=np.int32),
                                     items))
        valid = jnp.ones(kms.shape, bool)
        regs_l.append(np.asarray(hll_build.hll_build_batch(
            kms, valid, gids, p, len(chunk))))
        aux_l.append(np.asarray(hll_build.hll_build_batch(
            kms, valid, gids, p_aux, len(chunk))))
    return JaxBank(names=[f"g{i:05d}" for i in range(n)], p=p,
                   regs=np.concatenate(regs_l), aux_kind="hll",
                   aux=np.concatenate(aux_l), aux_param=p_aux)


@pytest.fixture(scope="module")
def hll_banks():
    return (validate_hllaux.build_hll_bank(SMALL, device="cpu"),
            _jax_hll_bank(SMALL))


def test_build_hll_bank_matches_jax(hll_banks):
    _same_bank(*hll_banks)


@pytest.mark.parametrize("crit", ["hll_a", "hll_an"])
def test_validate_hllaux_pairs_match_jax_host(crit, hll_banks):
    bank, jbank = hll_banks
    ok, got, _, _, _ = validate_screened.differential(
        bank, SelectionParams(tau=0.8, criterion=crit), "cpu")
    want = jhostref.select_pairs_host(jbank, 0.8, crit)
    assert ok and len(want) >= 24
    assert _rounded(got) == _rounded(want)


def test_validate_hllaux_main(capsys):
    assert validate_hllaux.main(["-n", str(SMALL), "--device", "cpu"]) == 0
    assert "HLL-AUX SCALE OK" in capsys.readouterr().out


def test_validate_hllaux_main_raises_on_mismatch(monkeypatch):
    real = validate_screened.select_pairs_screened
    monkeypatch.setattr(validate_screened, "select_pairs_screened",
                        lambda *a, **kw: real(*a, **kw)[:-1])
    with pytest.raises(RuntimeError, match="hll_a"):
        validate_hllaux.main(["-n", str(SMALL), "--device", "cpu"])


JAX_SWEEP_COLUMNS = ["threads", "ncpu", "pairs", "hist_pairs_per_sec",
                     "hist_plus_mle_pairs_per_sec"]


def test_confirm_thread_sweep_csv(tmp_path):
    """The JAX script's columns (experiments/confirm_thread_sweep.py), one
    row a thread count."""
    if not fastx.available():
        pytest.skip("libfastx did not build")
    out = tmp_path / "sweep.csv"
    assert confirm_thread_sweep.main([
        "--pairs", "2048", "--n", "256", "--reps", "1", "--threads", "1",
        "2", "--out", str(out)]) == 0
    with open(out, newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == JAX_SWEEP_COLUMNS
    assert [r[0] for r in rows[1:]] == ["1", "2"]


def test_confirm_thread_sweep_histograms_equal():
    """The sweep's histograms are equal at 1 and 2 threads, and equal to
    the numpy union histograms."""
    if not fastx.available():
        pytest.skip("libfastx did not build")
    rng = np.random.default_rng(42)
    regs = rng.integers(0, 12, size=(128, 1 << 14), dtype=np.uint8)
    ii = rng.integers(0, 128, 1000).astype(np.int64)
    kk = rng.integers(0, 128, 1000).astype(np.int64)
    one = fastx.pair_union_hist(regs, ii, kk, threads=1)
    assert np.array_equal(one, fastx.pair_union_hist(regs, ii, kk,
                                                     threads=2))
    assert np.array_equal(one, hostref.pair_union_histograms_np(regs, ii,
                                                                kk))
    rows = confirm_thread_sweep.sweep(128, 1000, 14, 1, [1, 2])
    assert [r["threads"] for r in rows] == [1, 2]


def test_confirm_thread_sweep_without_libfastx(monkeypatch, tmp_path,
                                               capsys):
    monkeypatch.setattr(confirm_thread_sweep.fastx, "available",
                        lambda: False)
    assert confirm_thread_sweep.main(["--out",
                                      str(tmp_path / "x.csv")]) == 1
    assert "libfastx unavailable" in capsys.readouterr().err
    assert not (tmp_path / "x.csv").exists()
