"""The port's last host helpers against the JAX package's: the numpy union
histograms' reused scratch, report, canonical_kmers_np, the scalar tile
scan and the .hll header's EstimationMethod codes. Integers and bytes
bit-equal, f64 estimates identical."""

import numpy as np
import pytest

from cuda_selection_criteria_tpu.ops import kmers as jkmers
from cuda_selection_criteria_tpu.parallel import scheduler as jscheduler
from cuda_selection_criteria_tpu.utils import formats as jformats
from cuda_selection_criteria_tpu.utils import hostref as jhostref
from cuda_selection_criteria_tpu_torch.native import fastx
from cuda_selection_criteria_tpu_torch.ops import kmers
from cuda_selection_criteria_tpu_torch.parallel import scheduler
from cuda_selection_criteria_tpu_torch.utils import formats, hostref


def _pairs(nb, n_rows, m, seed):
    rng = np.random.default_rng(seed)
    regs = rng.integers(0, 40, size=(n_rows, m), dtype=np.uint8)
    ii, kk = rng.integers(0, n_rows, size=(2, nb))
    return regs, ii, kk


@pytest.mark.parametrize("m", [256, 16384])
@pytest.mark.parametrize("nb", [0, 1, 63, 64, 65, 1000])
def test_pair_union_histograms_np_matches_jax(nb, m):
    """Bit-equal to the JAX numpy path and to the native fused pass. At
    nb = 0 the JAX numpy path raises (a block of 0 pairs steps range() by
    0); the port returns the empty (0, 64) array that both packages'
    dispatchers return."""
    regs, ii, kk = _pairs(nb, 50, m, seed=nb * 7 + m)
    got = hostref.pair_union_histograms_np(regs, ii, kk)
    assert got.dtype == np.int64 and got.shape == (nb, 64)
    if nb:
        np.testing.assert_array_equal(
            got, jhostref.pair_union_histograms_np(regs, ii, kk))
    else:
        with pytest.raises(ValueError):
            jhostref.pair_union_histograms_np(regs, ii, kk)
    np.testing.assert_array_equal(
        got, jhostref.pair_union_histograms(regs, ii, kk))
    if fastx.available():
        np.testing.assert_array_equal(got, fastx.pair_union_hist(regs, ii,
                                                                 kk))
    # any block gives the same histograms
    np.testing.assert_array_equal(
        got, hostref.pair_union_histograms_np(regs, ii, kk, block=7))


def test_pair_union_histograms_np_reuses_one_scratch():
    """A repeated shape reuses the same arrays; a new shape (block, m or
    dtype) clears the scratch and keeps its own alone; results stay equal
    to the JAX path across the changes."""
    hostref._hist_scratch.clear()
    regs, ii, kk = _pairs(200, 40, 256, seed=1)
    first = hostref.pair_union_histograms_np(regs, ii, kk)
    (key, arrays), = hostref._hist_scratch.items()
    assert key == (hostref._HIST_BLOCK, 256, np.dtype(np.uint8))
    again = hostref.pair_union_histograms_np(regs, ii[:100], kk[:100])
    (key2, arrays2), = hostref._hist_scratch.items()
    assert key2 == key and all(a is b for a, b in zip(arrays, arrays2))
    np.testing.assert_array_equal(again, first[:100])

    wide, wi, wk = _pairs(90, 30, 16384, seed=2)
    for regs_x, ii_x, kk_x in ((wide, wi, wk), (regs, ii, kk),
                               (wide, wi[:3], wk[:3]),
                               (regs.astype(np.int64), ii, kk)):
        got = hostref.pair_union_histograms_np(regs_x, ii_x, kk_x)
        np.testing.assert_array_equal(
            got, jhostref.pair_union_histograms_np(regs_x, ii_x, kk_x))
        (key, _), = hostref._hist_scratch.items()
        assert key == (min(hostref._HIST_BLOCK, len(ii_x)),
                       regs_x.shape[1], regs_x.dtype)
    assert hostref._HIST_BLOCK == jhostref._HIST_BLOCK == 64


@pytest.mark.parametrize("p", [8, 14])
def test_report_matches_jax(p):
    rng = np.random.default_rng(p)
    for top in (3, 20, 40):
        regs = rng.integers(0, top, size=(6, 1 << p), dtype=np.uint8)
        for r in regs:
            got = hostref.report(r, p)
            assert got == jhostref.report(r, p)
            assert got == hostref.ertl_mle_batch(
                hostref.histogram(r)[None], p)[0]


@pytest.mark.parametrize("k", [5, 31])
def test_canonical_kmers_np_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    codes[rng.integers(0, 3000, 40)] = 4  # resets
    got = kmers.canonical_kmers_np(codes, k=k, device="cpu")
    want = jkmers.canonical_kmers_np(codes, k=k)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert got.size > 1000


def test_block_ranges_matches_jax():
    for n in (0, 1, 7, 64, 65, 1000):
        for block in (1, 3, 64, 1024):
            got = scheduler.block_ranges(n, block)
            assert got == jscheduler.block_ranges(n, block)
            assert sum(b - a for a, b in got) == n


@pytest.mark.parametrize("use_cb_skip", [True, False])
def test_triangle_blocks_scalar_matches_jax_and_vectorized(use_cb_skip):
    """tests/test_scale_harness.py's fuzz: the port's scalar scan equals
    the JAX scalar scan and the port's vectorized triangle_blocks."""
    rng = np.random.default_rng(0x5C4ED)
    for _ in range(200):
        n = int(rng.integers(0, 160))
        block = int(rng.integers(1, 33))
        tau = float(rng.choice([0.0, 0.3, 0.9, 0.999, 1.0]))
        nz = int(rng.integers(0, n + 1)) if n else 0
        vals = np.sort(rng.choice([1.0, 2.0, 3.0, 5.0, 1e3, 1e3 + 1],
                                  size=n - nz)) if n else np.zeros(0)
        e = np.concatenate([np.zeros(nz), vals])
        got = scheduler.triangle_blocks_scalar(e, tau, block, use_cb_skip)
        assert got == jscheduler.triangle_blocks_scalar(e, tau, block,
                                                        use_cb_skip)
        assert got == scheduler.triangle_blocks(e, tau, block, use_cb_skip)


ESTIMS = ("ESTIM_ORIGINAL", "ESTIM_ERTL_IMPROVED", "ESTIM_ERTL_MLE",
          "ESTIM_ERTL_JOINT_MLE")


def test_estim_codes_match_jax():
    assert [getattr(formats, n) for n in ESTIMS] == \
        [getattr(jformats, n) for n in ESTIMS] == [0, 1, 2, 3]


@pytest.mark.parametrize("name", ESTIMS)
def test_write_hll_estim_bytes_match_jax(name, tmp_path):
    code = getattr(formats, name)
    regs = np.random.default_rng(code).integers(0, 30, 256, dtype=np.uint8)
    other = getattr(formats, ESTIMS[3 - code])
    for estim, jestim in ((code, code), (code, other)):
        a = tmp_path / f"port{estim}{jestim}.hll"
        b = tmp_path / f"jax{estim}{jestim}.hll"
        formats.write_hll(str(a), 8, regs, estim=estim, jestim=jestim)
        jformats.write_hll(str(b), 8, regs, estim=estim, jestim=jestim)
        assert a.read_bytes() == b.read_bytes()
        _, got, hdr = formats.read_hll(str(a))
        assert (hdr["estim"], hdr["jestim"]) == (estim, jestim)
        np.testing.assert_array_equal(got, regs)
