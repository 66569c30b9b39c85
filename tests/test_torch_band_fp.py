"""The LSH band fingerprints on the screened plan's path, held on the CPU
against the JAX package: parallel/screened.band_fingerprints (whose plain
version CPU tensors run) over the aux bank in its own row order with one
zero row, read through a shuffled row map whose padded positions name the
zero row, and the plan that fingerprints its smh aux bank that way.

- the plain version is bit-equal to the JAX band_fingerprints and to
  band_fingerprints_np of the host-sorted, zero-padded aux, at m = 8, 32,
  64 and 256 with criteria.smh_band_params' splits at tau 0.5, 0.8 and 0.9
  and its (1, m) fallback, on words with the top bit set and all-ones
  words, at a row count that is not a multiple of the tile;
- a numpy model of csrc/band_fp.cu's thread loop gives the same;
- the wrapper refuses what the kernel does not take;
- the plan's d_fp equals the JAX plan's for smh_a and smh_only, with no
  host band_fingerprints_np and no sorted host aux;
- select_pairs' lines equal the JAX package's for smh_a and smh_only, and
  the confirm's pairs equal those of the sorted host aux array.

Every comparison is exact. The kernel itself is held against its plain
version on the card in tests/test_torch_kernels_cuda.py and by
chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import band_fp_cases as cases
from torch_banks import jax_bank, port_bank

from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu_torch.ops import criteria
from cuda_selection_criteria_tpu_torch.parallel import screened
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams, select_pairs)
from cuda_selection_criteria_tpu_torch.utils.hostref import PairOracle


def _tensors(bank, rows):
    return (torch.from_numpy(bank.view(np.int64)), torch.from_numpy(rows))


@pytest.mark.parametrize("m,n_rows,n_bands", cases.SPLITS)
def test_plain_matches_jax_through_a_shuffled_map(m, n_rows, n_bands):
    """The wrapper (its plain version on the CPU) over the unsorted bank
    and a shuffled map equals the JAX band_fingerprints and
    band_fingerprints_np of the sorted, zero-padded aux, bit for bit."""
    aux = cases.aux_bank(m, seed=m + n_rows)
    bank, rows, aux_p = cases.plan_layout(aux, seed=n_bands)
    got = screened.band_fingerprints(*_tensors(bank, rows), n_rows, n_bands)
    want = np.asarray(jscreened.band_fingerprints(jnp.asarray(aux_p), n_rows,
                                                  n_bands))
    assert got.dtype == torch.int32 and got.shape == (len(rows), n_bands)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), screened.band_fingerprints_np(aux_p, n_rows, n_bands))
    np.testing.assert_array_equal(
        screened._band_fingerprints_plain(*_tensors(bank, rows), n_rows,
                                          n_bands).numpy(), want)
    # the padded positions read the zero row; both signs occur
    assert (want[cases.N:] == want[-1]).all()
    assert (want < 0).any() and (want > 0).any()


@pytest.mark.parametrize("m", [8, 32, 64, 256])
def test_smh_band_params_give_the_cases(m):
    """The cases' splits are smh_band_params' at tau 0.5, 0.8 and 0.9, and
    (1, m) is its fallback (tau 0.01: no band count reaches 0.95)."""
    got = {(m,) + criteria.smh_band_params(m, tau) for tau in (0.5, 0.8, 0.9)}
    assert criteria.smh_band_params(m, 0.01) == (1, m)
    assert got | {(m, 1, m)} == {s for s in cases.SPLITS if s[0] == m}


@pytest.mark.parametrize("m,n_rows,n_bands", [(8, 1, 8), (32, 4, 8),
                                              (64, 8, 8), (256, 1, 256)])
def test_kernel_model_matches_plain(m, n_rows, n_bands):
    """The numpy model of the kernel's thread loop (16-byte pairs for an
    even band, single words for an odd one) gives the plain version's
    fingerprints."""
    aux = cases.aux_bank(m, seed=3 * m)
    bank, rows, aux_p = cases.plan_layout(aux, seed=m)
    np.testing.assert_array_equal(
        cases.kernel_model(bank, rows, n_rows, n_bands),
        screened._band_fingerprints_plain(*_tensors(bank, rows), n_rows,
                                          n_bands).numpy())


def test_wrapper_checks():
    """band_fingerprints refuses a bank that is not contiguous 2-D int64,
    a map that is not contiguous 1-D int32, a split that is not m, and a
    map naming a row outside the bank; an empty map gives no rows."""
    aux = cases.aux_bank(32, seed=5)
    bank, rows, _ = cases.plan_layout(aux, seed=5)
    d_aux, d_rows = _tensors(bank, rows)
    bad = [
        (d_aux.view(torch.uint8), d_rows, 4, 8),
        (d_aux.to(torch.int32), d_rows, 4, 8),
        (d_aux.reshape(-1), d_rows, 4, 8),
        (d_aux[:, ::2], d_rows, 2, 8),
        (d_aux, d_rows.long(), 4, 8),
        (d_aux, d_rows[::2], 4, 8),
        (d_aux, d_rows[None], 4, 8),
        (d_aux, d_rows, 4, 4),
        (d_aux, d_rows, 0, 32),
        (d_aux, torch.full_like(d_rows, len(bank)), 4, 8),
        (d_aux, torch.full_like(d_rows, -1), 4, 8),
    ]
    for args in bad:
        with pytest.raises(ValueError, match="band_fingerprints"):
            screened.band_fingerprints(*args)
    empty = screened.band_fingerprints(d_aux, d_rows[:0], 4, 8)
    assert empty.shape == (0, 8) and empty.dtype == torch.int32


def _plans(crit, tau, seed=61, n=70, ti=16):
    jb = jax_bank(n, 10, 16, seed)
    jp = jscreened.ScreenPlan(jb, JParams(tau=tau, criterion=crit), ti)
    pp = screened.ScreenPlan(port_bank(jb),
                             SelectionParams(tau=tau, criterion=crit), ti,
                             device="cpu")
    return jb, jp, pp


@pytest.mark.parametrize("crit", ["smh_a", "smh_only"])
@pytest.mark.parametrize("tau", [0.2, 0.8])
def test_plan_fp_matches_jax_plan(monkeypatch, crit, tau):
    """The plan's d_fp, from the unsorted aux bank through d_rows, equals
    the JAX plan's (host band_fingerprints_np of the sorted, padded aux);
    the plan calls no band_fingerprints_np, gathers no sorted host aux,
    and times the pass inside plan's wall."""
    def no_host_fp(*_):
        raise AssertionError("the plan fingerprinted on the host")

    monkeypatch.setattr(screened, "band_fingerprints_np", no_host_fp)
    jb, jp, pp = _plans(crit, tau)
    assert pp.n_bands == jp.n_bands and pp.n_pad == jp.n_pad
    assert pp.d_fp.dtype == torch.int32
    np.testing.assert_array_equal(pp.d_fp.numpy(), np.asarray(jp.d_fp))
    assert pp.aux_s is None and pp.fp_secs >= 0.0


@pytest.mark.parametrize("crit", ["smh_a", "smh_only"])
def test_select_pairs_and_confirm_match(monkeypatch, crit):
    """select_pairs' lines equal the JAX select_pairs_screened's for the
    smh criteria, fp_secs lies inside plan_secs, and the plan's confirm
    (the candidates' aux rows read through the order) gives the pairs and
    Jaccards of PairOracle over the sorted host aux array; the sorted
    host aux is never gathered."""
    def no_host_fp(*_):
        raise AssertionError("the plan fingerprinted on the host")

    jb = jax_bank(40, 10, 16, 23)
    tau = 0.2
    want = jscreened.select_pairs_screened(
        jb, JParams(tau=tau, criterion=crit, block=64), ti=256, chunk=4)
    monkeypatch.setattr(screened, "band_fingerprints_np", no_host_fp)
    stats = {}
    got = select_pairs(port_bank(jb),
                       SelectionParams(tau=tau, criterion=crit,
                                       engine="screened"),
                       device="cpu", stats=stats)
    assert got == want and len(got) > 0
    assert 0.0 <= stats["fp_secs"] <= stats["plan_secs"]

    params = SelectionParams(tau=tau, criterion=crit)
    plan = screened.ScreenPlan(port_bank(jb), params, 16, device="cpu")
    rows, cols = plan.prune_tiles(*plan.schedule())
    cand = plan.screen_tiles(rows, cols, chunk=4)
    confirmed = plan.confirm(cand)
    assert plan.aux_s is None
    old = PairOracle(
        plan.bank.p, plan.regs_s, plan.e_s, aux=np.asarray(jb.aux)[plan.order],
        aux_param=plan.bank.aux_param, criterion=crit, tau=tau,
        apply_cb=plan.use_cb).confirm_pairs(cand)
    assert confirmed == old and len(confirmed) > 0
