"""What kernel K2 (csrc/weighted_cdf_sum.cu) reads and how it walks it, as
a plain model on the CPU, held against the port's plain version and the JAX
package.

The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py
holds it against the plain version there). Everything around its
instructions is modelled here: the pack stage's layout (a row of the plane
scratch is its nbins bit-planes one after the other, each max(2^p/32, 8)
uint32 words, the row padded with zero words to plane_row_words(p, nbins)),
the walk over that row (four 256-register mma depths a pipeline stage,
depth d belongs to bin d // (plane words / 8), a bin's first depth
overwrites the accumulator, depths past the last bin are never issued), the
counts (AND + popcount) and the fold (s = s + w_k * float(CDF_k), one
rounding per operation, ascending bins, the tail added last; Z = CDF_0).

Tolerance: none. The counts are exact integers and the fold repeats the
plain version's f32 operations in its order, so S and Z are bit-equal to
_screen_s_z_plain, which tests/test_torch_hllaux.py holds bit-equal to the
Pallas body in interpret mode; a few cases go to the Pallas body directly.
Also the stride helper, the device copies of the thresholds and weights,
and the wrapper's argument checks, which run before the device check and
so are reached here with meta tensors.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cuda_selection_criteria_tpu.ops import screen as jscreen
from cuda_selection_criteria_tpu_torch.ops import screen

STAGE_WORDS, DEPTH_WORDS = 32, 8


def pack_rows(regs, thresholds, p):
    """The pack stage's output for a uint8 bank (n, 2^p): uint32 (n,
    row_words), word k * W + w of a row holding bit t = [regs[32 w + t] <=
    thresholds[k]], W = max(2^p / 32, 8); every other word zero."""
    n, r = regs.shape
    w_real, w = r // 32, max(r // 32, DEPTH_WORDS)
    row_words = screen.plane_row_words(p, len(thresholds))
    planes = np.zeros((n, row_words), np.uint32)
    shifts = np.arange(32, dtype=np.uint64)
    for k, v in enumerate(thresholds):
        bits = (regs <= v).reshape(n, w_real, 32).astype(np.uint64)
        planes[:, k * w:k * w + w_real] = (bits << shifts).sum(-1).astype(
            np.uint32)
    return planes


def popcount_and(a, b):
    """int32 (rows of a, rows of b): set bits of a_i & b_j over the words."""
    both = a[:, None, :] & b[None, :, :]
    return np.unpackbits(both.view(np.uint8), axis=-1).sum(-1, dtype=np.int32)


def walk_block(rows, cols, p, weights, tail, want_z):
    """(S, Z) of one block of pairs from its packed rows and columns, walked
    as the kernel walks them."""
    row_words = rows.shape[1]
    assert row_words % STAGE_WORDS == 0 and cols.shape[1] == row_words
    g = max((1 << p) // 32, DEPTH_WORDS) // DEPTH_WORDS  # depths a bin
    n_depths = len(weights) * g
    s = np.zeros((rows.shape[0], cols.shape[0]), np.float32)
    z = acc = None
    folded = 0
    for stage in range(row_words // STAGE_WORDS):
        for step in range(STAGE_WORDS // DEPTH_WORDS):
            d = stage * (STAGE_WORDS // DEPTH_WORDS) + step
            if d >= n_depths:
                continue  # past the last bin: never issued
            lo = d * DEPTH_WORDS
            cnt = popcount_and(rows[:, lo:lo + DEPTH_WORDS],
                               cols[:, lo:lo + DEPTH_WORDS])
            acc = cnt if d % g == 0 else acc + cnt  # scale-d = 0 first
            if d % g == g - 1:
                k = d // g
                assert k == folded  # ascending bins, each folded once
                s = s + np.float32(weights[k]) * acc.astype(np.float32)
                if k == 0 and want_z:
                    z = acc.astype(np.float32)
                folded += 1
    assert folded == len(weights)
    return s + np.float32(tail), z


def model_s_z(regs, row_tiles, col_tiles, p, values, ti, tj, regs_cols=None):
    values, weights, tail, want_z = screen.telescope(p, values)
    rows = pack_rows(regs, values[:-1], p)
    cols = rows if regs_cols is None else pack_rows(regs_cols, values[:-1], p)
    # the words past a row's planes are zero
    assert not rows[:, len(weights) * max((1 << p) // 32, 8):].any()
    out = [walk_block(rows[r * ti:(r + 1) * ti], cols[c * tj:(c + 1) * tj],
                      p, weights, tail, want_z)
           for r, c in zip(row_tiles, col_tiles)]
    return (np.stack([s for s, _ in out]),
            np.stack([z for _, z in out]) if want_z else None)


def _case(p, nbins, zeros, sep_cols):
    lo = 0 if zeros else 2
    rng = np.random.default_rng(1000 * p + 10 * nbins + zeros)
    regs = rng.integers(lo, lo + nbins + 1, size=(192, 1 << p),
                        dtype=np.uint8)
    cols = (rng.integers(lo, lo + nbins + 1, size=(256, 1 << p),
                         dtype=np.uint8) if sep_cols else None)
    vals = screen.bank_values(regs if cols is None
                              else np.concatenate([regs, cols]))
    assert len(vals) == nbins + 1 and (vals[0] == 0) == zeros
    row_tiles = np.array([0, 2, 2], np.int32)
    col_tiles = np.array([1, 0, 0], np.int32)
    return regs, cols, vals, row_tiles, col_tiles


@pytest.mark.parametrize("p", range(5, 11))
@pytest.mark.parametrize("nbins", range(1, 15))
@pytest.mark.parametrize("zeros", [True, False])
def test_depth_walk_matches_plain(p, nbins, zeros):
    """The model of K2's pack layout, depth walk and fold == the plain
    version, S and Z bit-for-bit: a plane padded to one depth (p < 8), one,
    two and four depths a bin (p = 8, 9, 10), every bin count from 1 to 14
    (part-filled last stages), zeros present and absent, a separate column
    bank with another row count and tj != ti on every other case."""
    sep_cols = (p + nbins) % 2 == 1
    tj = 128 if sep_cols else 64
    regs, cols, vals, row_tiles, col_tiles = _case(p, nbins, zeros, sep_cols)
    s, z = screen._screen_s_z_plain(
        torch.from_numpy(regs), torch.from_numpy(row_tiles),
        torch.from_numpy(col_tiles), p, vals, 64, tj,
        regs_cols=None if cols is None else torch.from_numpy(cols))
    ms, mz = model_s_z(regs, row_tiles, col_tiles, p, vals, 64, tj, cols)
    assert ms.dtype == np.float32 and ms.shape == (3, 64, tj)
    np.testing.assert_array_equal(ms, s.numpy())
    assert (z is None) == (mz is None) == (not zeros)
    if zeros:
        np.testing.assert_array_equal(mz, z.numpy())


@pytest.mark.parametrize("p,nbins,zeros,sep_cols", [
    (5, 1, True, False), (6, 13, False, True), (8, 5, True, True),
    (9, 3, True, False), (10, 2, False, True),
])
def test_depth_walk_matches_pallas(p, nbins, zeros, sep_cols):
    """The same model == the Pallas _weighted_cdf_sum body in interpret
    mode, S and Z bit-for-bit (p <= 10 at ti = tj = 64: the register axis
    fits one r_sub block, so the reference folds in the same order)."""
    regs, cols, vals, row_tiles, col_tiles = _case(p, nbins, zeros, sep_cols)
    js, jz = jscreen.screen_s_z(
        jnp.asarray(regs), jnp.asarray(row_tiles), jnp.asarray(col_tiles), p,
        vals, ti=64, tj=64, interpret=True,
        regs_cols=None if cols is None else jnp.asarray(cols))
    ms, mz = model_s_z(regs, row_tiles, col_tiles, p, vals, 64, 64, cols)
    np.testing.assert_array_equal(ms, np.asarray(js))
    assert (jz is None) == (mz is None)
    if zeros:
        np.testing.assert_array_equal(mz, np.asarray(jz))


@pytest.mark.parametrize("p", range(5, 17))
@pytest.mark.parametrize("nbins", [1, 2, 3, 4, 5, 13, 14, 255])
def test_plane_row_words_is_whole_stages(p, nbins):
    """K2's plane scratch row: the bins' planes back to back, each at least
    one mma depth of 8 words, the row rounded up to whole 32-word stages by
    less than one stage."""
    words = screen.plane_row_words(p, nbins)
    used = nbins * max((1 << p) // 32, DEPTH_WORDS)
    assert words % STAGE_WORDS == 0 and used <= words < used + STAGE_WORDS
    if p >= 10:
        assert words == nbins * screen.plane_words(p)  # K1's padding


def test_device_telescope_is_kept_per_values():
    """The thresholds and weights go to the device once per (device, p,
    values), not at every launch, and equal telescope()'s."""
    dev = torch.device("cpu")
    thr, w = screen._device_telescope(dev, 8, (0, 1, 3, 7))
    thr2, w2 = screen._device_telescope(dev, 8, (0, 1, 3, 7))
    assert thr2 is thr and w2 is w
    values, weights, _, _ = screen.telescope(8, (0, 1, 3, 7))
    assert thr.dtype == torch.int32 and thr.tolist() == list(values[:-1])
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), np.asarray(weights, np.float32))
    assert screen._device_telescope(dev, 9, (0, 1, 3, 7))[0] is not thr


def _meta_args():
    regs = torch.zeros((256, 256), dtype=torch.uint8, device="meta")
    tiles = torch.zeros(2, dtype=torch.int32, device="meta")
    return dict(regs=regs, row_tiles=tiles, col_tiles=tiles, p=8,
                values=(0, 1, 3), ti=64, tj=128)


@pytest.mark.parametrize("change,match", [
    (dict(values=(0, 300)), "values outside uint8"),
    (dict(regs=torch.zeros((256, 256), dtype=torch.int32, device="meta")),
     "uint8"),
    (dict(regs=torch.zeros((256, 16), dtype=torch.uint8, device="meta"),
          p=4), "p >= 5"),
    (dict(ti=96), "multiple of 64"),
    (dict(ti=512), "multiple of 64"),
    (dict(tj=96), "tj must be a multiple of 64"),
    (dict(tj=192), "tj must be a multiple of 64"),
    (dict(regs_cols=torch.zeros((128, 128), dtype=torch.uint8,
                                device="meta")), "regs_cols must be"),
    (dict(regs_cols=torch.zeros((320, 256), dtype=torch.uint8,
                                device="meta")), "tile edge of regs_cols"),
    (dict(regs_cols=torch.zeros((384, 256), dtype=torch.uint8,
                                device="cpu")), "regs_cols must be"),
    (dict(row_tiles=torch.zeros(2, dtype=torch.int64, device="meta")),
     "int32"),
    (dict(col_tiles=torch.zeros(3, dtype=torch.int32, device="meta")),
     "int32"),
    (dict(row_tiles=torch.zeros(0, dtype=torch.int32, device="meta"),
          col_tiles=torch.zeros(0, dtype=torch.int32, device="meta")),
     "1..65535 tiles"),
    (dict(regs_cols=torch.zeros((384, 256), dtype=torch.uint8,
                                device="meta")), "unsupported device"),
    (dict(), "unsupported device"),
])
def test_k2_wrapper_checks_arguments_before_the_device(change, match):
    """Every check of screen_s_z runs before the device check, so each is
    reached here with meta tensors; inputs that pass them all stop at the
    device."""
    kw = _meta_args()
    kw.update(change)
    with pytest.raises(ValueError, match=match):
        screen.screen_s_z(**kw)
