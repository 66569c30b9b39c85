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
  the plain version's bits in f64 and f32 on every row, crafted rows and
  rows of real-sized genomes (synth.genome_hists), and the plain
  version's work counter (the kernel's bound) counts the model's steps;
- a model of the kernel's staging and blocking (32-row groups, persistent
  two-warp CTAs whose warps take groups w, w + W, ... each into its own
  part of the CTA's memory at an odd row stride, lane l copying bins l and
  l + 32): every bin staged once by the warp that owns its row, in
  bounds, in 32 banks a warp instruction; the
  fast route (4-byte copies) for every 4-byte element at any row stride
  and base offset; rows staged through the model's addresses give the
  plain version's bits; the grid spreads the 16k bank over every SM;
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


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_kernel_model_matches_plain_on_genome_rows(dt):
    """Rows of real-sized genomes (synth.genome_hists: 2^20 to 2^24
    hashes, no zero register, three secant steps and longer inner loops
    than the bench bank's): the kernel's per-row model gives the plain
    version's bits, and no row takes the log1p branch."""
    np_dt = np.dtype(np.float64 if dt == "f64" else np.float32)
    h = synth.genome_hists(96, 14, np.random.default_rng(0x6E0))
    assert not h[:, 0].any()
    work = {}
    plain = estimators._ertl_mle_plain(T(h), 14, dtype=_TORCH[np_dt],
                                       work=work).numpy()
    steps = {}
    model = [_kernel_model(row, 14, np_dt, steps=steps) for row in h]
    int_t = np.int64 if dt == "f64" else np.int32
    np.testing.assert_array_equal(
        plain.view(int_t), np.array([v for v, _ in model], np_dt).view(int_t))
    assert not any(b for _, b in model)
    assert steps["update_steps"] == work["update_steps"]
    assert work["update_steps"] > 40 * len(h)  # the bench bank's: about 23


# csrc/ertl_mle.cu's staging and blocking: kRows rows a group (one a lane),
# persistent CTAs of kWarps warps that share nothing, each warp staging one
# group at a time into its own part of the CTA's shared memory at an odd
# row stride; the SM's 228 KiB (1 KiB of it reserved a CTA) and 32 CTAs
# bound the CTAs that stay resident.
K_ROWS, K_WARPS = 32, 2
SM_SMEM, CTA_RESERVED, SM_CTAS = 228 * 1024, 1024, 32
ELEM = {"int32": 4, "int64": 8, "float32": 4}


def _row_words(p):
    return (66 - p) | 1


def _cta_smem(p):
    return K_WARPS * K_ROWS * _row_words(p) * 4


def _resident(p):
    return min(SM_CTAS, SM_SMEM // (_cta_smem(p) + CTA_RESERVED))


def _grid(n_rows, p, sms=132):
    groups = -(-n_rows // K_ROWS)
    return min(-(-groups // K_WARPS), sms * _resident(p))


def _async_route(in_kind):
    """The fast route (4-byte cp.async copies of the raw bits) takes every
    4-byte element type; int64 loads through registers."""
    return ELEM[in_kind] == 4


def _stage_model(n_rows, stride, p, grid):
    """Every copy of the kernel's staging, in issue order: int64 columns
    (cta, warp, group, lane, row, bin, source element, shared word, copy
    slot), the source element counted from the histograms' base
    (row * stride + bin) and the shared word from the CTA's dynamic shared
    memory. Warp w of CTA b (global warp b * K_WARPS + w) takes groups
    b * K_WARPS + w, + grid * K_WARPS, ... into its own part of the CTA's
    memory; lane l copies bins l and l + 32 (slot 1, where it is below
    q + 2) of each row of the group."""
    nb, ss = 66 - p, _row_words(p)
    n_groups = -(-n_rows // K_ROWS)
    out = []
    for cta in range(grid):
        for warp in range(K_WARPS):
            for g in range(cta * K_WARPS + warp, n_groups, grid * K_WARPS):
                rows = min(K_ROWS, n_rows - g * K_ROWS)
                for r in range(rows):
                    for slot in (0, 1):
                        for lane in range(32):
                            k = lane + 32 * slot
                            if k >= nb:
                                continue
                            row = g * K_ROWS + r
                            out.append((cta, warp, g, lane, row, k,
                                        row * stride + k,
                                        (warp * K_ROWS + r) * ss + k, slot))
    return np.array(out, np.int64).reshape(-1, 9)


@pytest.mark.parametrize("n_rows", [1, 31, 32, 33, 300])
@pytest.mark.parametrize("stride_extra", [0, 1, 12])
@pytest.mark.parametrize("grid", [1, 3, 64])
@pytest.mark.parametrize("p", [2, 8, 14, 24])
def test_stage_model_stages_every_bin_once(n_rows, stride_extra, grid, p):
    """The staging copies each bin 0..q+1 of every row exactly once, in the
    warp that owns the row's group; its words stay inside that warp's part
    of the CTA's memory, distinct within a group; a warp instruction's 32
    copies land in 32 banks and read contiguous elements; the loop's reads
    of one bin across a group's rows land in 32 banks (the odd row
    stride)."""
    nb, ss = 66 - p, _row_words(p)
    stride = nb + stride_extra
    grid = min(grid, _grid(n_rows, p))
    m = _stage_model(n_rows, stride, p, grid)
    cta, warp, g, lane, row, k, src, word, slot = m.T
    pairs = row * 64 + k
    assert len(np.unique(pairs)) == len(m) == n_rows * nb
    owner = (row // K_ROWS) % (grid * K_WARPS)
    np.testing.assert_array_equal(cta * K_WARPS + warp, owner)
    assert (src >= 0).all() and src.max() == (n_rows - 1) * stride + nb - 1
    assert (word >= 0).all() and word.max() * 4 < _cta_smem(p)
    np.testing.assert_array_equal(word // (K_ROWS * ss), warp)
    for key in np.unique(g):
        w = word[g == key]
        assert len(np.unique(w)) == len(w)
    inst = row * 2 + slot  # one warp instruction: a (row, slot)
    for key in np.unique(inst)[:64]:
        sel = inst == key
        assert len(np.unique(word[sel] % 32)) == sel.sum()
        np.testing.assert_array_equal(np.diff(np.sort(src[sel])), 1)
    for k0 in range(nb):
        reads = np.arange(K_ROWS) * ss + k0
        assert len(np.unique(reads % 32)) == K_ROWS


@pytest.mark.parametrize("in_kind", ["int32", "int64", "float32"])
@pytest.mark.parametrize("layout", ["contiguous", "row_hist", "slice"])
@pytest.mark.parametrize("base_elems", [0, 1, 3])
def test_staged_rows_give_the_plain_estimates(in_kind, layout, base_elems):
    """Histograms laid out as the callers hold them (q + 2 contiguous bins,
    row_hist's 64-bin rows, a slice of a wider last dimension) from a base
    0, 1 or 3 elements into a buffer (a base off 16-byte alignment): the
    byte address of every copy is a multiple of its element's size on the
    fast route, and the rows that the model stages into shared memory (as
    float: the raw float bits, int32 converted after the wait, int64
    through registers) give the plain version's bits and flags, f64 and
    f32, crafted and real-genome rows alike."""
    p, q = 14, 50
    nb = q + 2
    h = np.concatenate([_crafted(p, 20, 5),
                        synth.genome_hists(10, p, np.random.default_rng(9))])
    n = len(h)
    stride = {"contiguous": nb, "row_hist": 64, "slice": 71}[layout]
    np_in = {"int32": np.int32, "int64": np.int64,
             "float32": np.float32}[in_kind]
    flat = np.full(base_elems + n * stride + 5, 7, np_in)
    for r in range(n):
        flat[base_elems + r * stride:base_elems + r * stride + nb] = \
            h[r, :nb]
    grid = 2
    m = _stage_model(n, stride, p, grid)
    src = base_elems + m[:, 6]
    if _async_route(in_kind):
        assert ((src * ELEM[in_kind]) % 4 == 0).all()
    ss = _row_words(p)
    staged = np.full((n, ss), np.nan, np.float32)
    staged[m[:, 4], m[:, 5]] = flat[src].astype(np.float32)
    for dt in (np.dtype(np.float64), np.dtype(np.float32)):
        view = T(flat[base_elems:base_elems + n * stride].copy()).view(
            n, stride)[:, :nb]
        plain = estimators._ertl_mle_plain(view, p, dtype=_TORCH[dt])
        flags = estimators.log1p_branch(view, p, _TORCH[dt]).numpy()
        model = [_kernel_model(row, p, dt) for row in staged[:, :nb]]
        int_t = np.int64 if dt == np.float64 else np.int32
        np.testing.assert_array_equal(
            plain.numpy().view(int_t),
            np.array([v for v, _ in model], dt).view(int_t))
        np.testing.assert_array_equal(flags, [b for _, b in model])


def test_grid_fits_the_batch():
    """The persistent grid: the 16k bank's 512 groups in 256 CTAs over all
    132 SMs; 524,288 rows keep the resident CTAs busy (16 an SM at p=14, 14
    at p=8, 13 at p=2: 32, 28 and 26 warps) with 3 or 4 groups a warp; the
    CTAs' shared memory fits the SM at every p without an opt-in above
    48 KiB."""
    assert _grid(16384, 14) == 256 and 256 >= 132
    assert _resident(14) == 16 and _resident(8) == 14 and _resident(2) == 13
    assert _grid(524288, 14) == 132 * 16
    groups, warps = 524288 // K_ROWS, 132 * 16 * K_WARPS
    assert -(-groups // warps) == 4 and groups // warps == 3
    assert _grid(1, 14) == 1 and _grid(65, 8) == 2
    for p in range(2, 25):
        assert _resident(p) * (_cta_smem(p) + CTA_RESERVED) <= SM_SMEM
        assert _cta_smem(p) <= 48 * 1024


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
    "p_range", "p_25"])
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
            "p_range": (x, 40, {}),
            "p_25": (x, 25, {})}[case]
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
