"""The invariant that kernel K1's gate-first block skip rests on, held on
the CPU against the JAX package: a block of pairs whose gates all fail has
no hit, in the Pallas kernel (interpret mode, as tests/test_screen.py runs
it) and in the port's plain version, since hit = certificate AND gates.
The port's gate mask is bit-equal to the reference's _fused_gates, so the
kernel, which evaluates the same gates first and skips a block none of
whose pairs pass, writes what the plain version writes. Also the wrapper's
plane padding (plane_words) and its argument checks, which run before the
device check and so are reached here with meta tensors.

The kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cuda_selection_criteria_tpu.ops import screen as jscreen
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu_torch.ops import screen

P, TI, N = 8, 128, 384
ROWS = np.array([0, 0, 1, 1, 2], np.int32)  # diagonal, above and below it
COLS = np.array([0, 1, 0, 2, 2], np.int32)


def _inputs(seed, lo, scale=1.0):
    rng = np.random.default_rng(seed)
    regs = rng.integers(lo, 11, size=(N, 1 << P), dtype=np.uint8)
    e = (np.sort(rng.uniform(0, 5000, N)) * scale).astype(np.float32)
    e[:3] = 0.0  # empty rows exercise the e_b > 0 gate
    aux = rng.integers(0, 1 << 63, size=(N, 16), dtype=np.uint64)
    aux[1::7] = aux[0]  # rows sharing every LSH band with row 0
    return regs, e, jscreened.band_fingerprints_np(aux, 4, 4)


def _screen_both(regs, e, fp, n_real, use_cb, use_smh, tau_scr=0.4,
                 tau_cb=0.35):
    """(reference gate mask, reference hits in interpret mode, port plain
    hits, port gate mask), as numpy."""
    vals = screen.bank_values(regs)
    n_bands = fp.shape[1]
    jargs = (jnp.asarray(ROWS), jnp.asarray(COLS), jnp.asarray(e),
             jnp.asarray(fp), jnp.int32(n_real), jnp.float32(tau_scr),
             jnp.float32(tau_cb))
    jg = jscreen._fused_gates(*jargs, TI, n_bands, use_cb, use_smh)[2]
    jh, jc = jscreen.screen_hits_fused(jnp.asarray(regs), *jargs, P, vals,
                                       TI, n_bands, use_cb, use_smh,
                                       interpret=True)
    t = [torch.from_numpy(x) for x in (regs, ROWS, COLS, e, fp)]
    th, tc = screen._screen_hits_fused_plain(*t, n_real, tau_scr, tau_cb, P,
                                             vals, TI, n_bands, use_cb,
                                             use_smh)
    tg = screen._fused_gates(*t[1:], n_real, tau_scr, tau_cb, TI, n_bands,
                             use_cb, use_smh)[2]
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    return (np.asarray(jg).astype(bool), np.asarray(jh), th.numpy(),
            tg.numpy())


def _blocks(x, edge):
    """(T, TI/edge, TI/edge) sums of x over blocks of edge x edge pairs."""
    nb = TI // edge
    return x.reshape(x.shape[0], nb, edge, nb, edge).sum((2, 4),
                                                         dtype=np.int64)


def _check_dead_blocks(jg, jh, th, tg):
    """Gates equal, hits equal, and every all-dead block hit-free (at the
    64-edge of the v5e-era blocks and the 128-edge of K1's CTA)."""
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(th, jh)
    assert not (jh.astype(bool) & ~jg).any()
    dead_seen = 0
    for edge in (64, 128):
        dead = _blocks(jg, edge) == 0
        assert dead.any()
        for hits in (jh, th):
            assert (_blocks(hits, edge)[dead] == 0).all()
        dead_seen += int(dead.sum())
    return dead_seen


@pytest.mark.parametrize("use_cb,use_smh", [
    (True, True), (True, False), (False, True), (False, False),
])
@pytest.mark.parametrize("with_zeros", [True, False])
def test_all_dead_block_has_no_hits(use_cb, use_smh, with_zeros):
    """Every gate combination, with and without zero registers (Z present
    and absent), n_real short of the bank, tiles on, above and below the
    diagonal (the last wholly dead)."""
    regs, e, fp = _inputs(41 + use_cb + 2 * use_smh + 4 * with_zeros,
                          0 if with_zeros else 2, scale=20.0)
    jg, jh, th, tg = _screen_both(regs, e, fp, N - 5, use_cb, use_smh)
    _check_dead_blocks(jg, jh, th, tg)
    assert jh.sum() > 0
    assert not jg[2].any()  # tile (1, 0) lies below the diagonal


def test_one_live_pair_at_a_block_corner():
    """Gates that pass in exactly one pair, (i, j) = (63, 64): the corner
    of a 64-edge block, inside K1's 128-edge block."""
    regs, e, fp = _inputs(83, 0)
    e[:] = 1.0e6
    fp = np.arange(N * 4, dtype=np.int32).reshape(N, 4)
    fp[64, 2] = fp[63, 2]
    regs[64] = regs[63]
    jg, jh, th, tg = _screen_both(regs, e, fp, N, False, True)
    _check_dead_blocks(jg, jh, th, tg)
    assert jg.sum() == 1 and jg[0, 63, 64]
    assert jh.sum() == 1 and jh[0, 63, 64] == 1


@pytest.mark.parametrize("n_real", [37, 100, 200])
def test_n_real_inside_a_block(n_real):
    """n_real inside a 64- and a 128-edge block: the columns from n_real on
    are dead, the blocks wholly past it hit-free."""
    regs, e, fp = _inputs(190 + n_real, 0)
    e[:] = 1.0e6
    jg, jh, th, tg = _screen_both(regs, e, fp, n_real, True, False)
    _check_dead_blocks(jg, jh, th, tg)
    cols = COLS[:, None] * TI + np.arange(TI)[None, :]
    assert jh.sum() > 0
    assert not (jh.astype(bool) & (cols >= n_real)[:, None, :]).any()


@pytest.mark.parametrize("p", range(5, 19))
def test_plane_words_pads_to_a_whole_stage(p):
    """K1's bit-plane scratch: 2^p / 32 words a row and bin, at least one
    pipeline stage of 32 words (four 256-register depths of the 1-bit
    mma) - zero words past 2^p."""
    w = screen.plane_words(p)
    assert w == max((1 << p) // 32, 32)
    assert 32 * w >= 1 << p and w % screen.K1_STAGE_WORDS == 0


def _meta_args():
    regs = torch.zeros((256, 256), dtype=torch.uint8, device="meta")
    two = torch.zeros(2, dtype=torch.int32, device="meta")
    return dict(regs=regs, tiles=screen.LaunchTiles(*[two] * 6),
                e=torch.zeros(256, device="meta"),
                fp=torch.zeros((256, 1), dtype=torch.int32, device="meta"),
                n_real=250, tau_scr=0.1, tau_cb=0.1, p=8, values=(0, 1, 3),
                ti=64, n_bands=1, use_cb=True, use_smh=False)


@pytest.mark.parametrize("change,match", [
    (dict(values=(4,)), ">= 2 present values"),
    (dict(values=(0, 300)), "values outside uint8"),
    (dict(regs=torch.zeros((256, 256), dtype=torch.int32, device="meta")),
     "uint8"),
    (dict(regs=torch.zeros((256, 16), dtype=torch.uint8, device="meta"),
          p=4), "p >= 5"),
    (dict(ti=96), "multiple of 64"),
    (dict(ti=512), "multiple of 64"),
    (dict(row_tiles=torch.zeros(2, dtype=torch.int64, device="meta")),
     "int32"),
    (dict(col_tiles=torch.zeros(3, dtype=torch.int32, device="meta")),
     "int32"),
    (dict(row_tiles=torch.zeros(0, dtype=torch.int32, device="meta"),
          col_tiles=torch.zeros(0, dtype=torch.int32, device="meta")),
     "1..65535 tiles"),
    (dict(e=torch.zeros(255, device="meta")), "e must be"),
    (dict(e=torch.zeros(256, dtype=torch.float64, device="meta")),
     "e must be"),
    (dict(fp=torch.zeros((256, 2), dtype=torch.int32, device="meta")),
     "fp must be"),
    (dict(), "unsupported device"),
])
def test_wrapper_checks_arguments_before_the_device(change, match):
    """Every check of screen_hits_fused runs before the device check, so
    each is reached here with meta tensors; inputs that pass them all stop
    at the device."""
    kw = _meta_args()
    change = dict(change)
    kw["tiles"] = kw["tiles"]._replace(**{
        k: change.pop(k) for k in ("row_tiles", "col_tiles") if k in change})
    kw.update(change)
    with pytest.raises(ValueError, match=match):
        screen.screen_hits_fused(**kw)
