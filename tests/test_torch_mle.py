"""The ERTL-MLE kernel's path on the CPU, held against the JAX package and
the host oracle: estimators.ertl_mle (whose plain version CPU tensors run),
log1p_branch, and models/bank.cards_from_hists, the port's device branch
of SketchBank.compute_cards, which the screened plan's cardinalities take.

- the plain log1p_branch is the branch hostref.ertl_mle_batch's secant
  start takes (g0 > 1.5 a), on seeded pair unions and crafted rows (empty,
  saturated, one bin, log1p-branch rows with no register below q-1, a
  row count that is not a multiple of the kernel's 128-row CTA);
- cards_from_hists is bit-equal to host_cards' MLE and to the JAX
  package's hostref.ertl_mle_batch on every row, and to the JAX CPU-backend
  route (estimators.ertl_mle_from_regs) off the log1p branch; the rows it
  recomputes on the host are exactly the flagged ones, over their own
  histograms;
- a scalar numpy model of the kernel (csrc/ertl_mle.cu: one row at a time,
  its own loop to its own h_hi, the clamped powers of two, frexp) gives
  the plain version's bits in f64 and f32 on every row, and the plain
  version's work counter (the kernel's bound) counts the model's steps;
- the wrapper raises on what the kernel does not take (checked on meta
  tensors, which reach every check but the launch);
- ScreenPlan's cards and order, and select_pairs' lines for all six
  criteria, equal the JAX package's when the plan computes the cards.

Every comparison is exact. The kernel itself is held against its plain
version on the card in tests/test_torch_kernels_cuda.py and by
chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_banks import jax_bank, jax_bank_hll, one_torch_thread  # noqa: F401
from torch_banks import port_bank

from cuda_selection_criteria_tpu.ops import estimators as jestimators
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu.utils import hostref as jhostref
from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.models import bank as tbank
from cuda_selection_criteria_tpu_torch.ops import estimators, screen
from cuda_selection_criteria_tpu_torch.parallel import screened
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams, select_pairs)
from cuda_selection_criteria_tpu_torch.utils import hostref, synth

pytestmark = pytest.mark.usefixtures("one_torch_thread")
T = torch.from_numpy


def _crafted(p, n_pairs, seed):
    """int64 (N, 64) histograms at p: pair unions of seeded synthetic
    rows, 40 rows whose secant start takes the log1p branch (registers
    only at q-1, q and q+1, mostly q+1: chip_smoke.py phase 8's set), an
    empty row (c[0] = m), a saturated one (c[q+1] = m), one bin holding
    every register, a row of zeros and saturated registers only, and a
    row of two far bins; N is not a multiple of 128."""
    rng = np.random.default_rng(seed)
    q, m = 64 - p, 1 << p
    regs = synth.synthetic_regs(64, rng.integers(20, 200_000, 64), p, rng)
    ii, kk = rng.integers(0, 64, size=(2, n_pairs))
    pairs = hostref.pair_union_histograms_np(regs, ii, kk)
    deg = np.zeros((40, 64), np.int64)
    deg[:, q] = rng.integers(1, m // 3, 40)
    deg[:, q - 1] = rng.integers(0, 3, 40)
    deg[:, q + 1] = m - deg[:, q] - deg[:, q - 1]
    edge = np.zeros((5, 64), np.int64)
    edge[0, 0] = m
    edge[1, q + 1] = m
    edge[2, 7] = m
    edge[3, 0], edge[3, q + 1] = m // 2, m - m // 2
    edge[4, 1], edge[4, q] = m - 3, 3
    out = np.concatenate([pairs, deg, edge])
    assert len(out) % 128
    return out


def _hostref_branch(c, p):
    """hostref.ertl_mle_batch's secant-start branch, row by row: its own
    lines for z, a and g0 (utils/hostref.py, ertl_mle_batch), True where
    g0 > 1.5 a takes log1p."""
    q = 64 - p
    c = np.asarray(c, np.float64)[:, :q + 2]
    out = np.empty(len(c), bool)
    for i, row in enumerate(c):
        nz = np.flatnonzero(row > 0)
        k_min_p = max(1, nz[0]) if nz.size else 1
        k_max_p = min(q, nz[-1]) if nz.size else 0
        z = 0.0
        for k in range(q, 0, -1):
            if k_min_p <= k <= k_max_p:
                z = 0.5 * z + row[k]
        z = np.ldexp(z, -k_min_p)
        a = z + row[0]
        g0 = z + np.ldexp(row[q + 1], -q)
        out[i] = not g0 <= 1.5 * a
    return out


def _bits(x):
    return np.asarray(x, np.float64).view(np.int64)


@pytest.mark.parametrize("p", [8, 14])
def test_log1p_branch_is_hostrefs_branch(p):
    """The plain log1p_branch flags exactly the rows whose secant start in
    hostref.ertl_mle_batch (the port's and the JAX package's) calls log1p,
    in f64; the f32 flag agrees on these rows too."""
    h = _crafted(p, 300, 3 + p)
    want = _hostref_branch(h, p)
    assert want.sum() >= 41 and (~want).sum() >= 300
    got = estimators.log1p_branch(T(h), p).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        estimators.log1p_branch(T(h), p, torch.float32).numpy(), want)
    _, flags = estimators.ertl_mle(T(h), p, branch=True)
    np.testing.assert_array_equal(flags.numpy(), want)
    assert estimators.log1p_branch(T(h[:0]), p).shape == (0,)


@pytest.mark.parametrize("p", [8, 14])
@pytest.mark.parametrize("in_dtype", [np.int32, np.int64, np.float32])
def test_cards_from_hists_bit_equal_to_host(monkeypatch, p, in_dtype):
    """cards_from_hists gives host_cards' MLE (bank.mle_rows) and the JAX
    hostref.ertl_mle_batch bit for bit on every row, log1p rows included,
    and recomputes on the host exactly the flagged rows, over their own
    histograms."""
    h = _crafted(p, 400, 11 + p)
    flagged = np.flatnonzero(_hostref_branch(h, p))
    seen = []

    def recording(c, p_):
        seen.append(np.asarray(c))
        return hostref.ertl_mle_batch(c, p_)

    monkeypatch.setattr(tbank, "ertl_mle_batch", recording)
    cards, host_rows = tbank.cards_from_hists(T(h.astype(in_dtype)), p)
    assert cards.dtype == np.float64 and cards.shape == (len(h),)
    assert host_rows == len(flagged)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], h[flagged])
    np.testing.assert_array_equal(_bits(cards),
                                  _bits(tbank.mle_rows(h, p)))
    np.testing.assert_array_equal(_bits(cards),
                                  _bits(jhostref.ertl_mle_batch(h, p)))
    assert np.isinf(cards[-4]) and cards[-5] == 0.0  # saturated, empty


def test_cards_from_hists_without_log1p_rows_stay_off_the_host(monkeypatch):
    """Rows of real genomes have zero registers: none is recomputed, and
    the host oracle is not called."""
    rng = np.random.default_rng(5)
    regs = synth.synthetic_regs(300, rng.integers(64, 9000, 300), 12, rng)
    hists, _ = screen.row_hist(T(regs))

    def no_host(*_):
        raise AssertionError("a row went to the host")

    monkeypatch.setattr(tbank, "ertl_mle_batch", no_host)
    cards, host_rows = tbank.cards_from_hists(hists, 12)
    assert host_rows == 0
    np.testing.assert_array_equal(_bits(cards), _bits(hostref.ertl_mle_batch(
        tbank._row_hists_numpy(regs), 12)))


@pytest.mark.parametrize("p", [8, 14])
def test_cards_match_jax_cpu_route_off_log1p(p):
    """Off the log1p branch the port's cards (row_hist, then
    cards_from_hists) equal the JAX CPU backend's compute_cards route,
    estimators.ertl_mle_from_regs, on register banks, and its jitted
    ertl_mle on the crafted histograms, in f64; in f32 the plain version
    equals the JAX f32 MLE on the same rows."""
    rng = np.random.default_rng(40 + p)
    regs = synth.synthetic_regs(200, rng.integers(20, 200_000, 200), p, rng)
    hists, _ = screen.row_hist(T(regs))
    cards, host_rows = tbank.cards_from_hists(hists, p)
    assert host_rows == 0
    want = np.asarray(jestimators.ertl_mle_from_regs(jnp.asarray(regs), p))
    np.testing.assert_array_equal(_bits(cards), _bits(want))

    h = _crafted(p, 200, 17 + p)
    off = ~_hostref_branch(h, p)
    got = estimators.ertl_mle(T(h), p).numpy()
    jax64 = np.asarray(jestimators.ertl_mle(jnp.asarray(h), p))
    np.testing.assert_array_equal(_bits(got[off]), _bits(jax64[off]))
    got32 = estimators.ertl_mle(T(h), p, dtype=torch.float32).numpy()
    jax32 = np.asarray(jestimators.ertl_mle(jnp.asarray(h), p,
                                            dtype=jnp.float32))
    np.testing.assert_array_equal(got32[off].view(np.int32),
                                  jax32[off].view(np.int32))


def _kernel_model(row, p, dt, relerr=1e-2, steps=None):
    """csrc/ertl_mle.cu for one histogram row, in numpy scalars of dt (each
    operation rounded once in dt): the bins as float32, k_min / k_max by a
    scan, z high to low, the secant start with the log1p branch (torch's
    log1p, the plain version's library), then the row's own secant loop
    with its inner loop from min(64, h_hi) down to 1. steps, a dict, gets
    the row's z, secant, update and accumulation steps."""
    q, m = 64 - p, 1 << p
    c = np.asarray(row[:q + 2], np.float32)
    f = dt.type

    def pow2(e):
        return f(np.ldexp(1.0, max(-120, min(120, e))))

    nz = np.flatnonzero(c > 0)
    k_min_p = max(int(nz[0]), 1) if nz.size else 1
    k_max_p = min(int(nz[-1]), q) if nz.size else 0
    z = f(0)
    for k in range(k_max_p, k_min_p - 1, -1):
        z = f(0.5) * z + f(c[k])
    z = z * pow2(-k_min_p)
    c_prime = f(c[q + 1]) + f(c[k_max_p])
    a = z + f(c[0])
    m_prime = f(m) - f(c[0])
    g0 = z + f(c[q + 1]) * pow2(-q)
    secant = g0 <= f(1.5) * a
    with np.errstate(divide="ignore", invalid="ignore"):
        if secant:
            x = m_prime / (f(0.5) * g0 + a)
        else:
            lg = torch.log1p(torch.tensor(g0 / a, dtype=_TORCH[dt])).item()
            x = (m_prime / g0) * f(lg)
        eps = f(relerr) / np.sqrt(f(m))
        delta_x, g_prev = x, f(0)
        n = dict(z_steps=max(0, k_max_p - k_min_p + 1), secant_steps=0,
                 update_steps=0, acc_steps=0)
        while delta_x > x * eps:
            n["secant_steps"] += 1
            kappa_m1 = int(np.frexp(x)[1]) if x > 0 else 0
            h_hi = max(kappa_m1, k_max_p - 1)
            xp = x * pow2(-max(k_max_p + 1, kappa_m1 + 2))
            xpp = xp * xp
            h = (xp - xpp / f(3.0)) + (xpp * xpp) * (
                f(1.0 / 45.0) - xpp / f(472.5))
            g = f(0)
            for k in range(min(64, h_hi), 0, -1):
                if k == k_max_p - 1:
                    g = c_prime * h
                if k >= k_min_p:
                    n["update_steps"] += 1
                    hp = f(1.0) - h
                    h = (xp + h * hp) / (xp + hp)
                    xp = xp + xp
                    if k <= k_max_p - 1:
                        n["acc_steps"] += 1
                        g = g + f(c[k]) * h
            if k_max_p <= 1:
                g = c_prime * h
            g = g + x * a
            step = (delta_x * ((g - m_prime) / (g_prev - g))
                    if g_prev < g <= m_prime else f(0))
            x, delta_x, g_prev = x + step, step, g
    if steps is not None:
        for key, v in n.items():
            steps[key] = steps.get(key, 0) + v
    return (f(np.inf) if c[q + 1] == np.float32(m) else x * f(m)), \
        not secant


_TORCH = {np.dtype(np.float64): torch.float64,
          np.dtype(np.float32): torch.float32}


@pytest.mark.parametrize("p", [8, 14])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_kernel_model_matches_plain(p, dt):
    """The kernel's per-row loop (a numpy scalar model of csrc/ertl_mle.cu)
    gives the plain batched version's bits and flags on every crafted row,
    and the plain version's work counter counts the model's steps."""
    np_dt = np.dtype(np.float64 if dt == "f64" else np.float32)
    h = _crafted(p, 150, 23 + p)
    steps = {}
    model = [_kernel_model(row, p, np_dt, steps=steps) for row in h]
    work = {}
    plain = estimators._ertl_mle_plain(T(h), p, dtype=_TORCH[np_dt],
                                       work=work).numpy()
    want = np.array([v for v, _ in model], np_dt)
    int_t = np.int64 if dt == "f64" else np.int32
    np.testing.assert_array_equal(plain.view(int_t), want.view(int_t))
    np.testing.assert_array_equal(
        estimators.log1p_branch(T(h), p, _TORCH[np_dt]).numpy(),
        [b for _, b in model])
    for key, v in steps.items():
        assert work[key] == v, key
    assert work["rows"] == len(h) and work["ops"] == (
        10 * len(h) + 2 * steps["z_steps"] + 18 * steps["secant_steps"]
        + 6 * steps["update_steps"] + 2 * steps["acc_steps"])


def test_plain_layouts_and_shapes():
    """The plain version reads a slice of the last dimension, any batch
    shape and one histogram alone as the contiguous rows; an empty batch
    gives an empty result."""
    p, q = 10, 54
    h = _crafted(p, 130, 7)[:126].astype(np.float32)
    wide = np.zeros((126, 64), np.float32)
    wide[:, :q + 2] = h[:, :q + 2]
    want = estimators.ertl_mle(T(h[:, :q + 2].copy()), p)
    got = estimators.ertl_mle(T(wide).view(9, 14, 64)[..., :q + 2], p)
    assert got.shape == (9, 14)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want.numpy())
    one = estimators.ertl_mle(T(h[3]), p)
    assert one.shape == () and one.item() == want[3].item()
    empty, flags = estimators.ertl_mle(T(h[:0]), p, branch=True)
    assert empty.shape == (0,) and flags.shape == (0,)


@pytest.mark.parametrize("case", [
    "dtype16", "compute_f16", "few_bins", "bins_strided", "unmerged",
    "p_range"])
def test_wrapper_rejects_bad_inputs(case):
    """What the kernel does not take raises ValueError before any launch:
    meta tensors reach every check of the card path, then fail on the
    device; the slice of a wider last dimension passes every layout check.
    """
    x = torch.empty((5, 6, 64), dtype=torch.int32, device="meta")
    before = estimators.ertl_mle.launches
    args = {"dtype16": (x.to(torch.int16), 14, {}),
            "compute_f16": (x, 14, {"dtype": torch.float16}),
            "few_bins": (x[..., :51], 14, {}),
            "bins_strided": (torch.empty((5, 6, 128), dtype=torch.int32,
                                         device="meta")[..., ::2], 14, {}),
            "unmerged": (x.permute(1, 0, 2), 14, {}),
            "p_range": (x, 40, {})}[case]
    with pytest.raises(ValueError, match="ertl_mle") as err:
        estimators.ertl_mle(args[0], args[1], **args[2])
    assert "unsupported device" not in str(err.value)
    with pytest.raises(ValueError, match="unsupported device meta"):
        estimators.ertl_mle(x[..., :52], 14)
    assert estimators.ertl_mle.launches == before


def _plans(crit, seed=61, n=70, ti=16):
    if crit.startswith("hll"):
        jb = jax_bank_hll(n, 10, 6, seed)
    else:
        jb = jax_bank(n, 10, 16, seed)
    jp = jscreened.ScreenPlan(jb, JParams(tau=0.2, criterion=crit), ti)
    pb = port_bank(jb, cards=False)
    pp = screened.ScreenPlan(pb, SelectionParams(tau=0.2, criterion=crit),
                             ti, device="cpu")
    return jb, jp, pb, pp


@pytest.mark.parametrize("crit", ["smh_a", "hll_an", "baseline"])
def test_plan_cards_and_order_match_jax(monkeypatch, crit):
    """A card-less bank: the plan's cards (row_hist, then
    cards_from_hists, never host_cards) are the JAX bank's bits, its order
    and e the JAX plan's, and no row went to the host."""
    def no_host_cards(*_):
        raise AssertionError("the plan took host_cards")

    monkeypatch.setattr(tbank, "host_cards", no_host_cards)
    jb, jp, pb, pp = _plans(crit)
    np.testing.assert_array_equal(_bits(pb.cards), _bits(jb.cards))
    np.testing.assert_array_equal(pp.order, jp.order)
    np.testing.assert_array_equal(pp.e_s, jp.e_s)
    assert pp.cards_host_rows == 0
    kept = SketchBank(names=pb.names, regs=pb.regs, p=10, cards=pb.cards)
    assert screened.ScreenPlan(kept, SelectionParams(tau=0.2,
                                                     criterion="cb"),
                               16, device="cpu").cards_host_rows is None


@pytest.mark.parametrize("crit,tau", [
    ("smh_a", 0.2), ("smh_only", 0.2), ("cb", 0.2), ("baseline", 0.1),
    ("hll_a", 0.2), ("hll_an", 0.2)])
def test_select_pairs_with_plan_cards_match_jax(crit, tau):
    """select_pairs through the screened engine on a card-less bank (the
    plan computes the cards) gives the JAX select_pairs_screened's lines
    for every criterion; the stats carry cards_host_rows 0."""
    jb = (jax_bank_hll(20, 10, 6, 31) if crit.startswith("hll")
          else jax_bank(20, 10, 16, 17))
    want = jscreened.select_pairs_screened(
        jb, JParams(tau=tau, criterion=crit, block=64), ti=256, chunk=4)
    bank = port_bank(jb, cards=False)
    stats = {}
    got = select_pairs(bank, SelectionParams(tau=tau, criterion=crit,
                                             engine="screened"),
                       device="cpu", stats=stats)
    assert got == want and len(got) > 0
    assert stats["cards_host_rows"] == 0
    np.testing.assert_array_equal(_bits(bank.cards), _bits(jb.cards))
