"""The port's dense exact engine and its building blocks against the JAX
package, on inputs made once from a numpy seed: union histograms and
masks bit-equal, the f64 ERTL-MLE bit-equal to the JAX one and to the
host oracle's (utils/hostref.ertl_mle_batch), the f32 MLE within 1e-5 of
f64, and select_pairs(engine="dense") giving the JAX dense engine's lines
(adjudicated) and its exact f64 Jaccard values (adjudicate=False).
Mirrors tests/test_pairwise.py, tests/test_estimators.py and
tests/test_criteria.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import refmodels as rm
from torch_banks import (jax_bank, jax_bank_hll, one_torch_thread,  # noqa: F401
                         port_bank, rounded)

from cuda_selection_criteria_tpu.ops import criteria as jcriteria
from cuda_selection_criteria_tpu.ops import estimators as jest
from cuda_selection_criteria_tpu.ops import pairwise as jpairwise
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams, select_pairs as jselect_pairs)
from cuda_selection_criteria_tpu.utils import hostref as jhostref
from cuda_selection_criteria_tpu_torch.ops import criteria, estimators
from cuda_selection_criteria_tpu_torch.ops import pairwise
from cuda_selection_criteria_tpu_torch.parallel import selection
from cuda_selection_criteria_tpu_torch.parallel.screened import (
    select_pairs_screened)
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams, select_pairs)
from cuda_selection_criteria_tpu_torch.utils.hostref import ertl_mle_batch

T = torch.from_numpy
pytestmark = pytest.mark.usefixtures("one_torch_thread")
DTYPES = {"f64": (torch.float64, jnp.float64),
          "f32": (torch.float32, jnp.float32)}


def _regs(rng, n, width, p):
    return rng.integers(0, 64 - p + 2, size=(n, width), dtype=np.uint8)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("bi,bj,p,width", [
    (8, 9, 8, 256), (16, 17, 8, 256), (17, 8, 10, 1024), (12, 13, 6, 64),
    (13, 11, 8, 200), (9, 10, 7, 60), (3, 2, 10, 1024),
])
def test_union_histograms_match_jax(precision, bi, bj, p, width):
    rng = np.random.default_rng(bi * 100 + bj + width)
    a, b = _regs(rng, bi, width, p), _regs(rng, bj, width, p)
    got = pairwise.union_histograms(T(a), T(b), p, precision)
    want = np.asarray(jpairwise.union_histograms(
        jnp.asarray(a), jnp.asarray(b), p, precision))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if width == 1 << p:
        np.testing.assert_array_equal(
            want[2, 1], rm.sum_counts(np.maximum(a[2], b[1]))[: 64 - p + 2])


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_cdf_matmul_register_slices_sum_to_whole(precision):
    """Partial CDFs over register slices sum to the full CDF (the basis of
    the reference's register-sharded mesh)."""
    p = 8
    rng = np.random.default_rng(5)
    a, b = _regs(rng, 6, 256, p), _regs(rng, 20, 256, p)
    full = pairwise.cdf_matmul(T(a), T(b), p, precision)
    part = (pairwise.cdf_matmul(T(a[:, :96]), T(b[:, :96]), p, precision)
            + pairwise.cdf_matmul(T(a[:, 96:]), T(b[:, 96:]), p, precision))
    assert torch.equal(full, part)
    np.testing.assert_array_equal(full.numpy(), np.asarray(
        jpairwise.cdf_matmul(jnp.asarray(a), jnp.asarray(b), p)))


def _random_histograms(p, n, seed, max_card_exp=24):
    """Histograms of register banks of varied cardinality, then an empty
    and a saturated sketch."""
    rng = np.random.default_rng(seed)
    hists = []
    for _ in range(n):
        card = int(rng.integers(1, 1 << int(rng.integers(4, max_card_exp))))
        kms = rng.integers(0, 1 << 63, size=min(card, 20000), dtype=np.uint64)
        hists.append(rm.sum_counts(rm.build_hll([int(x) for x in kms], p)))
    q = 64 - p
    empty, full = np.zeros(64), np.zeros(64)
    empty[0] = full[q + 1] = 1 << p
    return np.stack(hists + [empty, full]).astype(np.float64)


@pytest.mark.parametrize("p", [8, 14])
def test_ertl_mle_f64_bit_equal_to_jax_and_host(p):
    hists = _random_histograms(p, 24, p)
    got = estimators.ertl_mle(T(hists), p)
    assert got.dtype == torch.float64
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jest.ertl_mle(jnp.asarray(hists), p)))
    np.testing.assert_array_equal(got, ertl_mle_batch(hists, p))
    assert got[-2] == 0.0 and np.isinf(got[-1])
    # the f32 mode: within 1e-5 relative of f64, and the JAX twin's f32
    g32 = estimators.ertl_mle(T(hists), p, dtype=torch.float32)
    assert g32.dtype == torch.float32
    g32 = g32.numpy()
    np.testing.assert_array_equal(g32, np.asarray(
        jest.ertl_mle(jnp.asarray(hists), p, dtype=jnp.float32)))
    fin = np.isfinite(got) & (got > 0)
    assert np.abs(g32[fin] / got[fin] - 1.0).max() <= 1e-5
    # a batch shape and int counts go through unchanged
    np.testing.assert_array_equal(
        estimators.ertl_mle(T(hists.astype(np.int64)).reshape(2, -1, 64),
                            p).numpy().ravel(), got)


def test_ertl_mle_log1p_branch_within_ulps():
    """The secant's start takes log1p only for histograms with no register
    below q-1 (never for a genome's sketch). There the libraries' log1p
    differ by an ulp, which the secant moves to up to 3 ulp: torch's and
    the JAX package's f64 MLE against glibc's (hostref), and each other."""
    rng = np.random.default_rng(1)
    p, q, m = 10, 54, 1 << 10
    c = np.zeros((2048, 64), np.int64)
    c[:, q] = rng.integers(1, m // 3, 2048)
    c[:, q - 1] = rng.integers(0, 3, 2048)
    c[:, q + 1] = m - c[:, q] - c[:, q - 1]
    got = estimators.ertl_mle(T(c), p).numpy()
    host = ertl_mle_batch(c, p)
    jax_ = np.asarray(jest.ertl_mle(jnp.asarray(c), p))
    assert np.isfinite(got).all()
    for a, b in ((got, host), (jax_, host), (got, jax_)):
        assert np.abs(a.view(np.int64) - b.view(np.int64)).max() <= 4


def test_ertl_mle_mixed_batch_convergence_isolated():
    """Elements with different secant step counts do not perturb each
    other: batched == one at a time."""
    p = 12
    hists = _random_histograms(p, 6, 3)
    batch = estimators.ertl_mle(T(hists), p).numpy()
    singles = [estimators.ertl_mle(T(h[None]), p).item() for h in hists]
    np.testing.assert_array_equal(batch, singles)
    assert estimators.ertl_mle(T(hists[:0]), p).shape == (0,)


def test_ertl_mle_from_regs_matches_jax():
    rng = np.random.default_rng(8)
    regs = rng.integers(0, 20, size=(5, 1 << 10), dtype=np.uint8)
    regs[1] = 0
    np.testing.assert_array_equal(
        estimators.ertl_mle_from_regs(T(regs), 10).numpy(),
        np.asarray(jest.ertl_mle_from_regs(jnp.asarray(regs), 10)))


def test_exact_power_helpers_match_jax():
    e = np.arange(-130, 131, dtype=np.int32)
    for tdt, jdt in DTYPES.values():
        np.testing.assert_array_equal(
            estimators.pow2_exact(T(e), tdt).numpy(),
            np.asarray(jest.pow2_exact(jnp.asarray(e), jdt)))
    rng = np.random.default_rng(2)
    x = np.concatenate([
        np.ldexp(1.0, np.arange(-119, 120)),
        np.nextafter(np.ldexp(1.0, np.arange(-119, 120)), 0.0),
        np.ldexp(rng.uniform(0.5, 1.0, 2000), rng.integers(-118, 119, 2000)),
        [0.0]])
    got = estimators.frexp_exponent(T(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jest.frexp_exponent(jnp.asarray(x))))
    np.testing.assert_array_equal(got[:-1], np.frexp(x[:-1])[1])
    k = rng.integers(-40, 40, x.size).astype(np.int32)
    np.testing.assert_array_equal(
        estimators.ldexp_exact(T(x), T(k)).numpy(),
        np.asarray(jest.ldexp_exact(jnp.asarray(x), jnp.asarray(k))))


@pytest.mark.parametrize("p", [10, 14])
def test_original_estimate_matches_jax(p):
    hists = _random_histograms(p, 12, 40 + p)[:-1]
    np.testing.assert_array_equal(
        estimators.original_estimate(T(hists), p).numpy(),
        np.asarray(jest.original_estimate(jnp.asarray(hists), p)))


def test_cb_and_smh_a_masks_match_jax():
    rng = np.random.default_rng(77)
    e1 = np.sort(rng.uniform(0, 3000, 9)).round()
    e2 = np.sort(rng.uniform(0, 3000, 12)).round()
    e2[0] = 0.0
    tau = criteria.effective_tau(0.5)
    np.testing.assert_array_equal(
        criteria.cb_mask(T(e1), T(e2), tau).numpy(),
        np.asarray(jcriteria.cb_mask(jnp.asarray(e1), jnp.asarray(e2), tau)))
    # SMH buckets with the high bit set: uint64 in, int64 bit patterns here
    a = (rng.integers(0, 3, size=(7, 16)).astype(np.uint64)
         | np.uint64(1 << 63))
    b = (rng.integers(0, 3, size=(9, 16)).astype(np.uint64)
         | np.uint64(1 << 63))
    b[2] = a[0]
    for n_rows, n_bands in ((2, 8), (4, 4), (1, 16)):
        got = criteria.smh_a_mask(T(a.view(np.int64)), T(b.view(np.int64)),
                                  n_rows, n_bands).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcriteria.smh_a_mask(
            jnp.asarray(a), jnp.asarray(b), n_rows, n_bands)))
        assert got[0, 2]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kind,order_n", [
    ("hll_a", 1), ("hll_an", 1), ("hll_an", 2), ("hll_an", 3),
])
def test_hll_masks_match_jax(kind, order_n, dtype):
    p = 8
    rng = np.random.default_rng(order_n + (kind == "hll_a"))
    cores, cards = [], []
    for _ in range(12):
        kms = rng.integers(0, 1 << 63, size=int(rng.integers(100, 5000)),
                           dtype=np.uint64)
        core = rm.build_hll([int(x) for x in kms], p)
        cores.append(core)
        cards.append(float(int(rm.report(core, p))))
    cores[3] = cores[2]  # a near pair
    cores = np.stack(cores)
    cards = np.sort(np.array(cards))
    tau = criteria.effective_tau(0.5)
    zs = criteria.z_sigma(1.96, p)
    tdt, jdt = DTYPES[dtype]
    args = (T(cores), T(cores), T(cards), T(cards), tau, zs, p)
    jargs = (jnp.asarray(cores), jnp.asarray(cores), jnp.asarray(cards),
             jnp.asarray(cards), tau, zs, p)
    if kind == "hll_a":
        got = criteria.hll_a_mask(*args, mle_dtype=tdt)
        want = jcriteria.hll_a_mask(*jargs, mle_dtype=jdt)
    else:
        got = criteria.hll_an_mask(*args, order_n, mle_dtype=tdt)
        want = jcriteria.hll_an_mask(*jargs, order_n, mle_dtype=jdt)
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 0 < got.sum() < got.size


def _banks(crit):
    if crit.startswith("hll"):
        jb = jax_bank_hll(40, 10, 6, 31)
    else:
        jb = jax_bank(40, 10, 16, 17)
    return jb, port_bank(jb)


CRITS = [("smh_a", 0.1), ("smh_only", 0.2), ("cb", 0.1), ("baseline", 0.2),
         ("hll_a", 0.1), ("hll_an", 0.2)]


@pytest.mark.parametrize("adjudicate", [True, False])
@pytest.mark.parametrize("crit,tau", CRITS)
def test_dense_engine_matches_jax(crit, tau, adjudicate):
    """Adjudicated: the JAX dense engine's lines. Unadjudicated: its pairs
    and device Jaccard floats, exactly (f64 on the CPU)."""
    jb, bank = _banks(crit)
    kw = dict(tau=tau, criterion=crit, engine="dense", block=16,
              adjudicate=adjudicate)
    want = jselect_pairs(jb, JParams(**kw))
    stats = {}
    got = select_pairs(bank, SelectionParams(**kw), device="cpu",
                       stats=stats)
    assert got == want
    assert len(got) >= 2
    assert stats["tiles"] == 6 and stats["candidates"] >= len(got)
    if adjudicate:
        host = jhostref.select_pairs_host(
            jb, tau, crit, apply_cb=crit not in ("baseline", "smh_only"))
        assert rounded(got) == rounded(host)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("crit,tau", CRITS)
def test_dense_engine_matches_screened(crit, tau, precision):
    jb, bank = _banks(crit)
    got = select_pairs(bank, SelectionParams(
        tau=tau, criterion=crit, engine="dense", precision=precision),
        device="cpu")
    assert got == select_pairs_screened(
        bank, SelectionParams(tau=tau, criterion=crit), ti=64, chunk=4,
        device="cpu")


@pytest.mark.parametrize("crit,block,n", [
    ("smh_a", 24, 40), ("baseline", 16, 37), ("hll_a", 9, 30),
    ("cb", 512, 13),
])
def test_dense_block_not_dividing_n(crit, block, n):
    if crit.startswith("hll"):
        jb = jax_bank_hll(n, 10, 6, 7)
    else:
        jb = jax_bank(n, 10, 16, 7)
    kw = dict(tau=0.05, criterion=crit, engine="dense", block=block,
              adjudicate=False)
    got = select_pairs(port_bank(jb), SelectionParams(**kw), device="cpu")
    assert got == jselect_pairs(jb, JParams(**kw))
    assert got


def test_dense_engine_f32_screen_dtype_matches_jax():
    """screen_dtype="f32" (the card's auto choice) on the CPU: the same
    unadjudicated f32 Jaccards as the JAX twin's f32 mode."""
    jb, bank = _banks("hll_an")
    kw = dict(tau=0.2, criterion="hll_an", engine="dense", block=16,
              adjudicate=False, screen_dtype="f32")
    assert select_pairs(bank, SelectionParams(**kw), device="cpu") == \
        jselect_pairs(jb, JParams(**kw))


def _resolved(monkeypatch, device, adjudicate):
    """The engine select_pairs' auto picks for this device and flag."""
    seen = []
    monkeypatch.setattr(selection, "select_pairs_dense",
                        lambda *a, **k: seen.append("dense") or [])
    monkeypatch.setattr(selection, "select_pairs_screened",
                        lambda *a, **k: seen.append("screened") or [])
    select_pairs(port_bank(jax_bank(4, 10, 16, 5)),
                 SelectionParams(tau=0.5, adjudicate=adjudicate),
                 device=device)
    return seen


def test_auto_is_dense_on_the_cpu(monkeypatch):
    """auto resolves as the reference does, with the device in place of
    its backend: dense on the CPU (there the MLE is f64)."""
    assert _resolved(monkeypatch, "cpu", True) == ["dense"]
    assert SelectionParams(tau=0.5).resolve_dtype("cpu") == torch.float64


def test_auto_is_dense_without_adjudication(monkeypatch):
    """Only the dense engine returns unadjudicated device Jaccards, so auto
    takes it whenever adjudicate is off, on CUDA too; with adjudication on
    CUDA it is the screened engine (the card's MLE dtype is f32)."""
    assert _resolved(monkeypatch, "cpu", False) == ["dense"]
    assert _resolved(monkeypatch, "cuda", False) == ["dense"]
    assert _resolved(monkeypatch, "cuda", True) == ["screened"]
    p = SelectionParams(tau=0.5)
    assert p.resolve_dtype("cuda") == p.resolve_dtype() == torch.float32
    assert SelectionParams(tau=0.5, screen_dtype="f32").resolve_dtype(
        "cpu") == torch.float32
