"""The port's screen (ops/screen.py) against the JAX package's.

Inputs come from a numpy seed and go through both packages. Hit masks,
counts and Z are compared bit-for-bit; S too, since both sum the same
exact integer CDFs in the same ascending order. The fused screen's plain
version is what CPU tensors run; the CUDA kernel is compared with it on
the card in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cuda_selection_criteria_tpu.ops import screen as jscreen
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu_torch.ops import screen
from cuda_selection_criteria_tpu_torch.parallel import screened


def _fused_inputs(seed, lo, hi, n=192, p=8, n_bands=4):
    rng = np.random.default_rng(seed)
    regs = rng.integers(lo, hi, size=(n, 1 << p), dtype=np.uint8)
    e = np.sort(rng.uniform(0, 5000, n)).astype(np.float32)
    e[:3] = 0.0  # empty rows exercise the e_b > 0 mask
    fp = jscreened.band_fingerprints_np(
        rng.integers(0, 1 << 63, size=(n, 4 * n_bands), dtype=np.uint64),
        4, n_bands)
    return regs, e, fp


ROWS = np.array([0, 0, 1, 2], np.int32)
COLS = np.array([0, 2, 1, 2], np.int32)


def _port_fused(regs, e, fp, vals, n_real, tau_scr, tau_cb, p, ti, use_cb,
                use_smh, rows=ROWS, cols=COLS):
    hits, counts = screen.screen_hits_fused(
        torch.from_numpy(regs), screen.launch_tiles(rows, cols, True, "cpu"),
        torch.from_numpy(e), torch.from_numpy(fp), n_real, tau_scr, tau_cb,
        p, vals, ti, fp.shape[1], use_cb, use_smh)
    return hits.numpy(), counts.numpy()


def _jax_fused(regs, e, fp, vals, n_real, tau_scr, tau_cb, p, ti, use_cb,
               use_smh, rows=ROWS, cols=COLS):
    hits, counts = jscreen.screen_hits_fused(
        jnp.asarray(regs), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(e), jnp.asarray(fp), jnp.int32(n_real),
        jnp.float32(tau_scr), jnp.float32(tau_cb), p, vals, ti, fp.shape[1],
        use_cb, use_smh, interpret=True)
    return np.asarray(hits), np.asarray(counts)


@pytest.mark.parametrize("use_cb,use_smh", [
    (True, True), (True, False), (False, True), (False, False),
])
@pytest.mark.parametrize("with_zeros", [True, False])
def test_plain_fused_matches_jax(use_cb, use_smh, with_zeros):
    """The cases of tests/test_screen.py::test_fused_kernel_matches_post:
    the port's plain K1 == the Pallas kernel in interpret mode == the
    two-pass screen_s_z + _screen_post, bit-for-bit."""
    p, ti, n = 8, 64, 192
    regs, e, fp = _fused_inputs(31 + use_cb + 2 * use_smh,
                                0 if with_zeros else 2, 11)
    vals = screen.bank_values(regs)
    assert vals == jscreen.bank_values(regs)
    args = (regs, e, fp, vals, n - 5, 0.4, 0.35, p, ti, use_cb, use_smh)
    got_h, got_c = _port_fused(*args)
    want_h, want_c = _jax_fused(*args)
    np.testing.assert_array_equal(got_h, want_h)
    np.testing.assert_array_equal(got_c, want_c)
    s, z = jscreen.screen_s_z(jnp.asarray(regs), jnp.asarray(ROWS),
                              jnp.asarray(COLS), p, vals, ti=ti, tj=ti)
    post = jscreened._screen_post(
        s, z, jnp.asarray(e), jnp.asarray(fp), jnp.asarray(ROWS) * ti,
        jnp.asarray(COLS) * ti, jnp.int32(n - 5), jnp.float32(0.4),
        jnp.float32(0.35), p, fp.shape[1], ti, ti, use_cb, use_smh)
    np.testing.assert_array_equal(got_h.astype(bool), np.asarray(post))


def test_plain_fused_truncated_values_matches_jax():
    """A truncated value list (one-sided tail) through both kernels."""
    p, ti, n = 8, 64, 192
    regs, e, fp = _fused_inputs(21, 0, 26)
    full = screen.bank_values(regs)
    vals = screen.truncate_values(full, max_card=40.0, p=p)
    assert vals == jscreen.truncate_values(full, 40.0, p)
    assert len(vals) < len(full)
    args = (regs, e, fp, vals, n - 5, 0.2, 0.15, p, ti, True, False)
    got_h, got_c = _port_fused(*args)
    want_h, want_c = _jax_fused(*args)
    np.testing.assert_array_equal(got_h, want_h)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_c.sum() > 0


@pytest.mark.parametrize("lo,hi,truncate", [
    (0, 13, False),   # zeros present: Z emitted
    (9, 19, False),   # no zeros: Z omitted
    (0, 26, True),    # truncated telescope
    (4, 5, False),    # single present value: constant S, no Z
    (0, 1, False),    # single value 0: constant S and Z
])
def test_screen_s_z_matches_jax(lo, hi, truncate):
    p, ti = 8, 64
    rng = np.random.default_rng(5 + lo + hi)
    regs = rng.integers(lo, hi, size=(192, 1 << p), dtype=np.uint8)
    vals = screen.bank_values(regs)
    if truncate:
        vals = screen.truncate_values(vals, 40.0, p)
    s, z = screen.screen_s_z(torch.from_numpy(regs), torch.from_numpy(ROWS),
                             torch.from_numpy(COLS), p, vals, ti=ti, tj=ti)
    js, jz = jscreen.screen_s_z(jnp.asarray(regs), jnp.asarray(ROWS),
                                jnp.asarray(COLS), p, vals, ti=ti, tj=ti)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (z is None) == (jz is None)
    if z is not None:
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))


def test_single_value_chunk_matches_jax():
    """A single-value bank cannot use K1; the chunk takes the two-pass
    form (screen_s_z constants + _screen_post) in both packages."""
    p, ti, n = 8, 64, 192
    rng = np.random.default_rng(3)
    regs = np.full((n, 1 << p), 3, np.uint8)
    e = np.sort(rng.uniform(0, 5000, n)).astype(np.float32)
    fp = np.zeros((n, 1), np.int32)
    vals = screen.bank_values(regs)
    assert len(vals) == 1
    hits, counts = screened._screen_chunk(
        torch.from_numpy(regs), screen.launch_tiles(ROWS, COLS, True, "cpu"),
        torch.from_numpy(e), torch.from_numpy(fp), n - 5, np.float32(0.1), np.float32(0.05), p, vals, ti, 1, True,
        False)
    jh, jc = jscreened._screen_chunk(
        jnp.asarray(regs), jnp.asarray(ROWS), jnp.asarray(COLS),
        jnp.asarray(e), jnp.asarray(fp), jnp.int32(n - 5),
        jnp.float32(0.1), jnp.float32(0.05), p, vals, ti, 1, True, False)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts.sum() > 0


def test_bank_values_matches_jax():
    """Present-value scan, chunked, on arrays and tensors; gaps and 255."""
    rng = np.random.default_rng(8)
    regs = rng.choice(np.array([0, 3, 4, 9, 255], np.uint8), size=(37, 300))
    want = jscreen.bank_values(regs)
    assert want == (0, 3, 4, 9, 255)
    assert screen.bank_values(regs) == want
    assert screen.bank_values(torch.from_numpy(regs)[5:], chunk=1000) == \
        jscreen.bank_values(regs[5:])
    with pytest.raises(ValueError, match="uint8"):
        screen.bank_values(regs.astype(np.int32))


def test_mle_lower_bound_matches_jax():
    rng = np.random.default_rng(2)
    s = rng.uniform(10, 900, 64).astype(np.float32)
    z = np.floor(rng.uniform(0, 3, 64) * s / 3).astype(np.float32)
    for zz in (z, None):
        got = screen.mle_lower_bound(
            torch.from_numpy(s), None if zz is None else torch.from_numpy(zz),
            10)
        want = jscreen.mle_lower_bound(
            jnp.asarray(s), None if zz is None else jnp.asarray(zz), 10)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_rejects_unsupported_inputs():
    """The wrapper's argument checks run before any kernel is touched;
    a meta tensor reaches them on a machine without a card."""
    regs = torch.zeros((128, 256), dtype=torch.uint8, device="meta")
    one = torch.zeros(1, dtype=torch.int32, device="meta")
    tiles = screen.LaunchTiles(one, one, one, one, one, one)
    e = torch.zeros(128, device="meta")
    fp = torch.zeros((128, 1), dtype=torch.int32, device="meta")
    # argument checks come before the device check (all of them:
    # tests/test_torch_k1_skip.py)
    with pytest.raises(ValueError, match="uint8"):
        screen.screen_hits_fused(regs.to(torch.int32), tiles, e, fp,
                                 128, 0.1, 0.1, 8, (0, 1), 64, 1, True, False)
    with pytest.raises(ValueError, match="multiple of 64"):
        screen.screen_hits_fused(regs, tiles, e, fp, 128, 0.1, 0.1, 8,
                                 (0, 1), 96, 1, True, False)
    with pytest.raises(ValueError, match="unsupported device"):
        screen.screen_hits_fused(
            regs, tiles, torch.zeros(128, device="meta"),
            torch.zeros((128, 1), dtype=torch.int32, device="meta"), 128,
            0.1, 0.1, 8, (0, 1), 64, 1, True, False)
