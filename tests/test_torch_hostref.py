"""The port's host helpers against the JAX package's: the f64 oracle,
estimator constants, criteria, the scheduler, file bytes and the bank.
Floats from the f64 MLE must be identical, integers and bytes bit-equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_banks import jax_bank, port_bank

from cuda_selection_criteria_tpu.ops import criteria as jcriteria
from cuda_selection_criteria_tpu.ops import estimators as jestimators
from cuda_selection_criteria_tpu.parallel import scheduler as jscheduler
from cuda_selection_criteria_tpu.utils import filelist as jfilelist
from cuda_selection_criteria_tpu.utils import formats as jformats
from cuda_selection_criteria_tpu.utils import hostref as jhostref
from cuda_selection_criteria_tpu_torch.models.bank import host_cards
from cuda_selection_criteria_tpu_torch.ops import criteria, estimators
from cuda_selection_criteria_tpu_torch.parallel import scheduler
from cuda_selection_criteria_tpu_torch.utils import filelist, formats, hostref


@pytest.mark.parametrize("p", [6, 8, 10, 14])
def test_ertl_mle_batch_matches_jax(p):
    rng = np.random.default_rng(11)
    regs = rng.integers(0, 30, size=(40, 1 << p), dtype=np.uint8)
    hists = np.stack([hostref.histogram(r) for r in regs])
    np.testing.assert_array_equal(
        hists, np.stack([jhostref.histogram(r) for r in regs]))
    got = hostref.ertl_mle_batch(hists, p)
    np.testing.assert_array_equal(got, jhostref.ertl_mle_batch(hists, p))
    np.testing.assert_array_equal(
        got, [jhostref.ertl_mle_scalar(c, p) for c in hists])
    np.testing.assert_array_equal(
        got, [hostref.ertl_mle_scalar(c, p) for c in hists])


def test_ertl_mle_degenerate_histograms_match_jax():
    p, m = 10, 1 << 10
    cases = []
    for v in (1, 2, 3, 7, 0, 64 - p + 1):
        c = np.zeros(64, np.int64)
        c[v] = m
        cases.append(c)
    hists = np.stack(cases)
    got = hostref.ertl_mle_batch(hists, p)
    np.testing.assert_array_equal(got, jhostref.ertl_mle_batch(hists, p))
    assert np.isinf(got[-1])


@pytest.mark.parametrize("p", [8, 14])
def test_hll_histogram_matches_jax(p):
    rng = np.random.default_rng(p)
    regs = rng.integers(0, 64 - p + 2, size=(33, 1 << p), dtype=np.uint8)
    got = estimators.hll_histogram(torch.from_numpy(regs), p)
    want = jestimators.hll_histogram(jnp.asarray(regs, jnp.int32), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ii = rng.integers(0, 33, 50)
    kk = rng.integers(0, 33, 50)
    np.testing.assert_array_equal(
        hostref.pair_union_histograms_np(regs, ii, kk),
        jhostref.pair_union_histograms_np(regs, ii, kk))


@pytest.mark.parametrize("crit", ["smh_a", "cb", "baseline"])
def test_confirm_pairs_matches_jax(crit):
    """tests/test_hostref_batch.py's confirm_pairs case on both oracles:
    identical pair sets and f64 Jaccard values, equal to evaluate()."""
    rng = np.random.default_rng(23)
    n, p = 30, 8
    regs = rng.integers(0, 25, size=(n, 1 << p), dtype=np.uint8)
    regs[1::3] = regs[0]  # planted near-duplicates
    regs[1::3, :4] += 1
    e = np.trunc(host_cards(regs, p))
    aux = rng.integers(0, 1 << 40, size=(n, 16), dtype=np.uint64)
    aux[1::3] = aux[0]
    kw = dict(aux=aux, aux_param=16, criterion=crit, tau=0.3,
              apply_cb=(crit != "baseline"))
    pairs = [(i, k) for i in range(n - 1) for k in range(i + 1, n)]
    oracle = hostref.PairOracle(p, regs, e, **kw)
    got = oracle.confirm_pairs(pairs, batch=64)
    assert got == jhostref.PairOracle(p, regs, e, **kw).confirm_pairs(pairs)
    want = [(i, k, j) for (i, k) in pairs
            for sel, j in [oracle.evaluate(i, k)] if sel]
    assert got == want and len(got) > 0


def test_oracle_rejects_unported_criteria():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hostref.PairOracle(10, np.zeros((2, 1024), np.uint8), np.ones(2),
                           criterion="hll_a")


def test_criteria_constants_match_jax():
    for m in (8, 16, 32, 64, 128):
        for tau in (0.01, 0.2, 0.5, 0.9, 0.99):
            assert criteria.smh_band_params(m, tau) == \
                jcriteria.smh_band_params(m, tau)
    for tau in (0.9, 0.3, 1 / 3):
        assert criteria.effective_tau(tau) == jcriteria.effective_tau(tau)
    for p in range(4, 15):
        assert estimators.sigma(p) == jestimators.sigma(p)
        assert criteria.z_sigma(1.96, p) == jcriteria.z_sigma(1.96, p)
    for m in (16, 32, 64, 1024):
        assert estimators.make_alpha(m) == jestimators.make_alpha(m)


def test_triangle_block_ids_matches_jax():
    rng = np.random.default_rng(0x5C4ED)
    for _ in range(100):
        n = int(rng.integers(0, 160))
        block = int(rng.integers(1, 33))
        tau = float(rng.choice([0.0, 0.3, 0.9, 0.999, 1.0]))
        nz = int(rng.integers(0, n + 1)) if n else 0
        vals = (np.sort(rng.choice([1.0, 2.0, 3.0, 5.0, 1e3, 1e3 + 1],
                                   size=n - nz)) if n else np.zeros(0))
        e = np.concatenate([np.zeros(nz), vals])
        for cb in (True, False):
            got = scheduler.triangle_block_ids(e, tau, block, cb)
            want = jscheduler.triangle_block_ids(e, tau, block, cb)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            tiles = scheduler.triangle_blocks(e, tau, block, cb)
            assert tiles == jscheduler.triangle_blocks(e, tau, block, cb)
            assert scheduler.pair_count(tiles, n) == \
                jscheduler.pair_count(tiles, n)


def test_sketch_file_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    regs = rng.integers(0, 20, size=1 << 14, dtype=np.uint8)
    h = rng.integers(0, 1 << 63, size=32, dtype=np.uint64)
    for mod, tag in ((formats, "port"), (jformats, "jax")):
        mod.write_hll(str(tmp_path / f"{tag}.hll"), 14, regs)
        mod.write_smh(str(tmp_path / f"{tag}.smh32"), h)
    for ext in ("hll", "smh32"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    p, core, header = formats.read_hll(str(tmp_path / "jax.hll"))
    assert p == 14 and header["magic"] == 1
    np.testing.assert_array_equal(core, regs)
    np.testing.assert_array_equal(
        formats.read_smh(str(tmp_path / "jax.smh32")), h)
    with pytest.raises(ValueError, match="register count"):
        formats.write_hll(str(tmp_path / "bad.hll"), 10, regs)


def test_file_list_messages_match_jax(tmp_path):
    for mod in (filelist, jfilelist):
        with pytest.raises(ValueError, match="No input file provided"):
            mod.load_file_list("")
        with pytest.raises(FileNotFoundError,
                           match="No valid input file provided"):
            mod.load_file_list(str(tmp_path / "missing.txt"))
    lst = tmp_path / "list.txt"
    lst.write_text(" a.fna\r\n\n\tb.fna \n")
    assert filelist.load_file_list(str(lst), "/x/") == \
        jfilelist.load_file_list(str(lst), "/x/") == ["/x/a.fna", "/x/b.fna"]


def test_bank_from_arrays_matches_jax():
    """State carried across: the port's bank from a reference bank's
    arrays keeps its cards, recomputes identical ones with the host f64
    MLE, and sorts identically."""
    jb = jax_bank(24, 10, 16, 3)
    carried = port_bank(jb)
    recomputed = port_bank(jb, cards=False)
    np.testing.assert_array_equal(carried.cards, jb.cards)
    np.testing.assert_array_equal(recomputed.cards, jb.cards)
    np.testing.assert_array_equal(recomputed.sorted_by_cardinality(),
                                  jb.sorted_by_cardinality())
    assert recomputed.n == jb.n and recomputed.aux_param == jb.aux_param
