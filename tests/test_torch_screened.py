"""The port's screened engine (parallel/screened.py) against the JAX
package's, on banks made once from a numpy seed: gate counts, hit
coordinates, the confirm stage's device histograms and reject flags, and
tile schedules bit-equal; selected pairs and Jaccard values identical."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_banks import jax_bank, port_bank, rounded

from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu.utils import hostref as jhostref
from cuda_selection_criteria_tpu_torch.parallel import screened
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams, select_pairs)
from cuda_selection_criteria_tpu_torch.utils.hostref import (
    PairOracle, select_pairs_host)


@pytest.mark.parametrize("use_cb,use_smh", [
    (True, True), (True, False), (False, True),
])
def test_gate_counts_matches_jax(use_cb, use_smh):
    rng = np.random.default_rng(13 + use_cb + 2 * use_smh)
    n, ti, n_bands = 256, 64, 4
    e = np.sort(rng.uniform(0, 3000, n)).astype(np.float32)
    e[:5] = 0.0
    aux = rng.integers(0, 1 << 63, size=(n, 8), dtype=np.uint64)
    aux[1::7] = aux[0]  # planted band collisions
    fp = screened.band_fingerprints_np(aux, 2, n_bands)
    rows, cols = np.triu_indices(4)
    rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    tau_cb = np.float32(0.8)
    got = screened._gate_counts(
        torch.from_numpy(e), torch.from_numpy(fp), torch.from_numpy(rows),
        torch.from_numpy(cols), n - 7, tau_cb, n_bands, ti, use_cb, use_smh)
    want = jscreened._gate_counts(
        jnp.asarray(e), jnp.asarray(fp), jnp.asarray(rows),
        jnp.asarray(cols), jnp.int32(n - 7), tau_cb, n_bands, ti, use_cb,
        use_smh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < len(rows) * ti * ti


def test_band_fingerprints_and_thresholds_match_jax():
    rng = np.random.default_rng(7)
    for n_rows, n_bands in ((4, 8), (2, 16), (8, 4), (1, 32)):
        aux = rng.integers(0, 1 << 63, size=(37, n_rows * n_bands),
                           dtype=np.uint64)
        np.testing.assert_array_equal(
            screened.band_fingerprints_np(aux, n_rows, n_bands),
            jscreened.band_fingerprints_np(aux, n_rows, n_bands))
    for tau in (0.02, 0.3, 0.9):
        assert screened.screen_tau(tau) == jscreened.screen_tau(tau)
    for n in (2, 4095, 4096, 16384):
        assert screened.auto_tile(n) == jscreened.auto_tile(n)
        ti = screened.auto_tile(n)
        assert screened.auto_chunk(ti) == jscreened.auto_chunk(ti)
    assert screened.reject_delta_for(14, 1e-3) == \
        jscreened.reject_delta_for(14, 1e-3)


def test_extract_hit_coords_matches_jax():
    rng = np.random.default_rng(4)
    ti = 64
    hits = (rng.random((6, ti, ti)) < 0.01).astype(np.int8)
    hits[2] = 0
    ts = np.array([0, 1, 3, 5])
    got = screened.extract_hit_coords(torch.from_numpy(hits), ts)
    want = jscreened.extract_hit_coords(
        jnp.asarray(hits), ts, hits.reshape(6, -1).sum(1)[ts], ti)

    def as_set(res):
        return {(int(t), int(r), int(c))
                for t, rr, cc in res for r, c in zip(rr, cc)}

    assert as_set(got) == as_set(want)
    assert len(as_set(got)) == int(hits[ts].sum())


def _plans(crit, tau, ti=64, seed=41, n=24):
    jb = jax_bank(n, 10, 16, seed)
    return (jscreened.ScreenPlan(jb, JParams(tau=tau, criterion=crit), ti),
            screened.ScreenPlan(port_bank(jb), SelectionParams(
                tau=tau, criterion=crit), ti, device="cpu"))


@pytest.mark.parametrize("crit,tau", [
    ("smh_a", 0.2), ("cb", 0.5), ("baseline", 0.3),
])
def test_plan_schedule_prune_and_bank_match_jax(crit, tau):
    jp, pp = _plans(crit, tau, ti=16, n=70)
    rows, cols = pp.schedule()
    jrows, jcols = jp.schedule()
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(cols, jcols)
    prow, pcol = pp.prune_tiles(rows, cols, chunk=8)
    jprow, jpcol = jp.prune_tiles(jrows, jcols, chunk=8)
    np.testing.assert_array_equal(prow, jprow)
    np.testing.assert_array_equal(pcol, jpcol)
    assert pp.values == jp.values
    assert pp.tau_scr == jp.tau_scr and pp.tau_cb == jp.tau_cb
    np.testing.assert_array_equal(pp.d_regs.numpy(), np.asarray(jp.d_regs))
    np.testing.assert_array_equal(pp.d_e.numpy(), np.asarray(jp.d_e))
    np.testing.assert_array_equal(pp.d_fp.numpy(), np.asarray(jp.d_fp))


@pytest.mark.parametrize("tau", [0.02, 0.6, -100.0])
def test_hist_flag_matches_jax(tau):
    """The confirm stage's device op: union histograms (int16 at p <= 14)
    and certain-reject flags bit-equal to the reference's hist_flag."""
    jp, pp = _plans("baseline", 0.02)
    n = pp.n
    ii, kk = np.triu_indices(n, 1)
    pend, nb = pp.device_hist_fn(chunk=64, tau=tau).dispatch(ii, kk)
    jpend, jnb = jp.device_hist_fn(chunk=64, tau=tau).dispatch(ii, kk)
    assert nb == jnb == len(ii)
    hist = torch.cat([h for h, _ in pend]).numpy()
    rej = torch.cat([r for _, r in pend]).numpy()
    assert hist.dtype == np.int16
    np.testing.assert_array_equal(
        hist, np.concatenate([np.asarray(h) for h, _ in jpend])[:nb])
    np.testing.assert_array_equal(
        rej, np.concatenate([np.asarray(r) for _, r in jpend])[:nb])
    if tau >= 0.6:
        assert rej.any()


@pytest.mark.parametrize("tau", [0.02, 0.2, 0.6, 0.9])
def test_device_hist_fn_reject_bound_exact(tau):
    """tests/test_screen.py::test_device_hist_fn_reject_bound_exact on the
    port: the reject bound leaves the emitted pairs and Jaccard values
    bit-identical to the plain host confirmation."""
    _, plan = _plans("baseline", tau)
    pairs = [(i, k) for i in range(plan.n) for k in range(i + 1, plan.n)]

    def oracle(hist_fn=None):
        return PairOracle(plan.bank.p, plan.regs_s, plan.e_s,
                          criterion="baseline", tau=tau, apply_cb=False,
                          hist_fn=hist_fn)

    want = oracle().confirm_pairs(pairs)
    got = oracle(plan.device_hist_fn(chunk=64, tau=tau)).confirm_pairs(pairs)
    assert want == got


def test_device_hist_fn_negative_tau_never_rejects():
    _, plan = _plans("baseline", 0.9)
    pairs = [(i, k) for i in range(plan.n) for k in range(i + 1, plan.n)]
    kw = dict(criterion="baseline", tau=-100.0, apply_cb=False)
    want = PairOracle(plan.bank.p, plan.regs_s, plan.e_s,
                      **kw).confirm_pairs(pairs)
    got = PairOracle(plan.bank.p, plan.regs_s, plan.e_s,
                     hist_fn=plan.device_hist_fn(chunk=64, tau=-100.0),
                     **kw).confirm_pairs(pairs)
    assert want == got
    assert len(want) == len(pairs)
    with pytest.raises(ValueError, match="exceeds"):
        PairOracle(plan.bank.p, plan.regs_s, plan.e_s,
                   hist_fn=plan.device_hist_fn(tau=0.5), **kw)


@pytest.mark.parametrize("crit,tau", [
    ("smh_a", 0.2), ("cb", 0.2), ("baseline", 0.3), ("smh_a", 0.02),
])
def test_select_pairs_screened_matches_jax_and_host(crit, tau):
    """The cases of tests/test_screen.py::test_screened_engine_matches_host
    (smh_only is not ported)."""
    jb = jax_bank(20, 10, 16, 17)
    bank = port_bank(jb)
    host = jhostref.select_pairs_host(jb, tau, crit,
                                      apply_cb=(crit != "baseline"))
    want = jscreened.select_pairs_screened(
        jb, JParams(tau=tau, criterion=crit, block=64), ti=256, chunk=4)
    stats = {}
    got = screened.select_pairs_screened(
        bank, SelectionParams(tau=tau, criterion=crit), ti=256, chunk=4,
        device="cpu", stats=stats)
    assert got == want
    assert rounded(got) == rounded(host)
    assert got == select_pairs_host(bank, tau, crit,
                                    apply_cb=(crit != "baseline"))
    assert stats["confirmed"] == len(got) and stats["candidates"] >= len(got)
    assert select_pairs(bank, SelectionParams(tau=tau, criterion=crit),
                        device="cpu") == got


def test_select_pairs_screened_edge_cases():
    """n=2, zero-cardinality genomes (tests/test_screen.py:272-294)."""
    jb = jax_bank(2, 10, 16, 53)
    got = screened.select_pairs_screened(
        port_bank(jb), SelectionParams(tau=0.1), ti=256, chunk=2,
        device="cpu")
    host = jhostref.select_pairs_host(jb, 0.1, "smh_a")
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in host]

    jb2 = jax_bank(10, 10, 16, 54)
    for i in (3, 7):
        jb2.regs[i] = 0
        jb2.aux[i] = np.uint64(0xFFFFFFFFFFFFFFFF)
    jb2.compute_cards()
    bank2 = port_bank(jb2, cards=False)
    np.testing.assert_array_equal(bank2.cards, jb2.cards)
    got2 = screened.select_pairs_screened(
        bank2, SelectionParams(tau=0.1), ti=256, chunk=2, device="cpu")
    assert rounded(got2) == rounded(jhostref.select_pairs_host(
        jb2, 0.1, "smh_a"))


def test_unported_criteria_and_engines_raise():
    bank = port_bank(jax_bank(4, 10, 16, 5))
    with pytest.raises(ValueError, match="does not support"):
        screened.ScreenPlan(bank, SelectionParams(tau=0.2, criterion="hll_a"),
                            64, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        select_pairs(bank, SelectionParams(tau=0.2, engine="dense"),
                     device="cpu")


def test_default_device_is_cuda():
    """No silent CPU fallback: without an explicit device the engine
    places its bank on CUDA (and raises on a machine without a card)."""
    from cuda_selection_criteria_tpu_torch.utils import device

    assert device.resolve(None) == torch.device("cuda")
    assert device.resolve("cpu") == torch.device("cpu")
