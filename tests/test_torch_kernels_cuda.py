"""The port's CUDA kernel and its card path against their plain versions.

Needs an NVIDIA card: every test skips without one (the kernel has no CPU
mode). Imports neither JAX nor the reference package, so it also runs on
the machine with the card, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.models.bank import host_cards
from cuda_selection_criteria_tpu_torch.ops import screen
from cuda_selection_criteria_tpu_torch.parallel import screened
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)
from cuda_selection_criteria_tpu_torch.utils import synth


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, lo, hi, n, p, n_bands=4):
    rng = np.random.default_rng(seed)
    regs = rng.integers(lo, hi, size=(n, 1 << p), dtype=np.uint8)
    e = np.sort(rng.uniform(0, 5000, n)).astype(np.float32)
    e[:3] = 0.0
    aux = rng.integers(0, 1 << 63, size=(n, 4 * n_bands), dtype=np.uint64)
    aux[1::5] = aux[0]
    fp = screened.band_fingerprints_np(aux, 4, n_bands)
    return regs, e, fp


def _compare(dev, regs, e, fp, rows, cols, vals, p, ti, use_cb, use_smh,
             tau_scr=0.4, tau_cb=0.35):
    args = [torch.from_numpy(np.asarray(x)).to(dev)
            for x in (regs, rows, cols, e, fp)]
    kw = dict(n_real=regs.shape[0] - 5, tau_scr=tau_scr, tau_cb=tau_cb, p=p,
              values=vals, ti=ti, n_bands=fp.shape[1], use_cb=use_cb,
              use_smh=use_smh)
    before = screen.screen_hits_fused.launches
    got = screen.screen_hits_fused(*args, **kw)
    want = screen._screen_hits_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    assert screen.screen_hits_fused.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return int(got[1].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("use_cb,use_smh", [
    (True, True), (True, False), (False, True), (False, False),
])
@pytest.mark.parametrize("with_zeros", [True, False])
def test_kernel_matches_plain_p8(cuda, use_cb, use_smh, with_zeros):
    regs, e, fp = _inputs(31 + use_cb + 2 * use_smh,
                          0 if with_zeros else 2, 11, 192, 8)
    _compare(cuda, regs, e, fp, np.array([0, 0, 1, 2], np.int32),
             np.array([0, 2, 1, 2], np.int32), screen.bank_values(regs), 8,
             64, use_cb, use_smh)


@pytest.mark.cuda
@pytest.mark.parametrize("ti", [128, 256])
def test_kernel_matches_plain_multi_cta_truncated(cuda, ti):
    """Several 64 x 64 CTAs per schedule tile, p=10, a truncated value
    list, off-diagonal and diagonal tiles, planted near-duplicates."""
    rng = np.random.default_rng(7 + ti)
    regs = synth.synthetic_regs(512, rng.integers(300, 3000, 512), 10, rng)
    aux = synth.synthetic_aux(512, 16, rng)
    synth.plant_near_duplicates(regs, aux, rng, 40)
    e = np.trunc(host_cards(regs, 10)).astype(np.float32)
    e[:3] = 0.0
    fp = screened.band_fingerprints_np(aux, 4, 4)
    vals = screen.truncate_values(screen.bank_values(regs), e.max(), 10)
    nb = 512 // ti
    rows, cols = np.triu_indices(nb)
    hits = _compare(cuda, regs, e, fp, rows.astype(np.int32),
                    cols.astype(np.int32), vals, 10, ti, True, False,
                    tau_scr=0.1, tau_cb=0.05)
    assert hits > 0


@pytest.mark.cuda
@pytest.mark.parametrize("crit", ["smh_a", "cb", "baseline"])
def test_engine_on_cuda_matches_cpu(cuda, crit):
    rng = np.random.default_rng(5)
    regs = synth.synthetic_regs(300, rng.integers(400, 900, 300), 10, rng)
    aux = synth.synthetic_aux(300, 16, rng)
    synth.plant_near_duplicates(regs, aux, rng, 12)
    bank = SketchBank(names=[f"g{i}" for i in range(300)], regs=regs, p=10,
                      aux_kind="smh", aux=aux, aux_param=16)
    params = SelectionParams(tau=0.5, criterion=crit)
    before = screen.screen_hits_fused.launches
    got = screened.select_pairs_screened(bank, params, ti=128, chunk=4,
                                         device=cuda)
    assert screen.screen_hits_fused.launches > before
    want = screened.select_pairs_screened(bank, params, ti=128, chunk=4,
                                          device="cpu")
    assert got == want and len(got) >= 12


@pytest.mark.cuda
def test_device_hist_fn_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(9)
    regs = rng.integers(0, 25, size=(40, 1 << 8), dtype=np.uint8)
    bank = SketchBank(names=[f"g{i}" for i in range(40)], regs=regs, p=8)
    params = SelectionParams(tau=0.3, criterion="cb")
    ii, kk = np.triu_indices(40, 1)
    for tau in (0.3, -100.0):
        outs = [screened.ScreenPlan(bank, params, 64, device=d)
                .device_hist_fn(chunk=100, tau=tau)(ii, kk)
                for d in (cuda, "cpu")]
        np.testing.assert_array_equal(*outs)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs_on_cuda(cuda):
    regs = torch.zeros((128, 256), dtype=torch.int32, device=cuda)
    tiles = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        screen.screen_hits_fused(
            regs, tiles, tiles, torch.zeros(128, device=cuda),
            torch.zeros((128, 1), dtype=torch.int32, device=cuda), 128, 0.1,
            0.1, 8, (0, 1), 64, 1, True, False)
