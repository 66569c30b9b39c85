"""The bank's cardinalities on the screened plan's path, held on the CPU
against the JAX package: the row histograms (ops/screen.row_hist, whose
plain version CPU tensors run), the lazy SketchBank.cards, and the plan
that uploads the bank unsorted, takes the histograms and the present
values from one pass, sets the cards and reads the sorted rows through a
row map.

- the plain row histograms equal the JAX package's two rules (the host
  bincount of row * 64 + reg, models/bank.py:97-103, and
  estimators.hll_histogram) on uniform, skewed and HLL-built banks, with
  all-zero rows and values up to 64 - p + 1; a value of 64 raises;
- a numpy model of the kernel's split (csrc/row_hist.cu: unaligned heads
  and tails one byte a lane, 16-byte vectors dealt to 32 lanes, each
  byte below 64, zeros included, one count on the lane's own 32-bit
  counter of its value, counters carried over a warp's rows and read as
  differences modulo 2^32) gives the same histograms and present values
  on skewed, dense genome-like and one-value rows;
- a bank made without cards computes host_cards' bits at its first read,
  bit-equal to the JAX SketchBank's; the plan sets them from its own pass
  without host_cards, and keeps cards a bank was given;
- the plan's order, e, present values, fingerprints and sorted bank equal
  the JAX plan's, with and without cards given;
- K1's plain version through a shuffled row map (the plan's layout: its
  own row order and a zero row) equals it on the gathered sorted bank;
- select_pairs' lines equal the JAX select_pairs_screened for smh_a,
  hll_a, hll_an, cb and baseline, with and without cards given.

Every comparison is exact. The kernel itself is held against its plain
version on the card in tests/test_torch_kernels_cuda.py and by
chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_banks import jax_bank, jax_bank_hll, port_bank

from cuda_selection_criteria_tpu.models.bank import SketchBank as JBank
from cuda_selection_criteria_tpu.ops import estimators as jestimators
from cuda_selection_criteria_tpu.ops import screen as jscreen
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.models import bank as tbank
from cuda_selection_criteria_tpu_torch.ops import screen
from cuda_selection_criteria_tpu_torch.parallel import screened
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams, select_pairs)


def _jax_bincount(regs):
    """The JAX SketchBank.compute_cards histograms on an accelerator
    (models/bank.py:97-103): one bincount of row * 64 + reg."""
    n = regs.shape[0]
    offs = (np.arange(n, dtype=np.int64)[:, None] * 64
            + regs.astype(np.int64))
    return np.bincount(offs.ravel(), minlength=n * 64).reshape(n, 64)


def _hll_like(rng, n, r, top):
    """Rows skewed as HLL rows of 2048 hashes at p=14: about 12% non-zero,
    geometric values capped at `top`."""
    hit = rng.random((n, r)) < 0.12
    return np.where(hit, np.minimum(rng.geometric(0.5, (n, r)), top),
                    0).astype(np.uint8)


def _bank(kind, p, seed):
    rng = np.random.default_rng(seed)
    top = 64 - p + 1  # the largest HLL register value at precision p
    if kind == "uniform":
        regs = rng.integers(0, top + 1, (29, 1 << p), dtype=np.uint8)
    elif kind == "skewed":
        regs = _hll_like(rng, 29, 1 << p, top)
    else:  # "hll built": the JAX package's own HLL build of planted items
        regs = np.array(jax_bank(29, p, 16, seed).regs)
    regs[[0, 11]] = 0  # all-zero rows
    regs[5, 3] = top
    return regs


@pytest.mark.parametrize("kind", ["uniform", "skewed", "hll built"])
@pytest.mark.parametrize("p", [6, 10, 14])
def test_plain_row_hist_matches_jax_rules(kind, p):
    """The plain version (in 2048-row chunks and in chunks of 4 rows)
    equals the JAX host bincount and estimators.hll_histogram, and its
    values the JAX bank_values."""
    regs = _bank(kind, p, 40 + p)
    want = _jax_bincount(regs)
    jhist = np.asarray(jestimators.hll_histogram(jnp.asarray(regs), p))
    for chunk in (2048, 4):
        hist, vals = screen.row_hist(torch.from_numpy(regs), chunk)
        assert hist.dtype == torch.int32 and hist.shape == (29, 64)
        np.testing.assert_array_equal(hist.numpy(), want)
        q2 = 64 - p + 2
        np.testing.assert_array_equal(hist.numpy()[:, :q2], jhist)
        assert not hist.numpy()[:, q2:].any()
        assert vals == jscreen.bank_values(regs)
        assert vals[0] == 0 and vals[-1] == 64 - p + 1


def test_row_hist_refuses_what_has_no_bin():
    """A register value of 64 or more raises, as native.row_hist does
    (the JAX bincount would fold it into the next row's bins); a bank that
    is not 2-D uint8 raises; no rows give no values."""
    regs = _bank("skewed", 10, 3)
    for v in (64, 200):
        bad = regs.copy()
        bad[28, 1] = v
        with pytest.raises(ValueError, match=">= 64"):
            screen.row_hist(torch.from_numpy(bad))
    with pytest.raises(ValueError, match="uint8"):
        screen.row_hist(torch.from_numpy(regs.astype(np.int32)))
    with pytest.raises(ValueError, match="2-D"):
        screen.row_hist(torch.from_numpy(regs.reshape(-1)))
    hist, vals = screen.row_hist(torch.zeros((0, 1024), dtype=torch.uint8))
    assert hist.shape == (0, 64) and vals == ()


def _dense_like(rng, n, r, p=14):
    """Rows of real-sized genomes' registers at p (a cardinality
    log-uniform in [2^20, 2^24] a row, each register R = ceil(log2(lam /
    E)) for E ~ Exp(1), clamped to [0, 64 - p + 1]): no zero byte at p=14,
    the values spread over a few neighbours."""
    lam = np.exp(rng.uniform(np.log(2.0 ** 20), np.log(2.0 ** 24),
                             (n, 1))) / (1 << p)
    e = rng.exponential(size=(n, r))
    return np.clip(np.ceil(np.log2(lam / e)), 0, 64 - p + 1).astype(np.uint8)


def _one_value(n, r, values=(0, 1, 9, 51, 63)):
    """Rows of r bytes that all hold one value, a value a row."""
    return np.repeat(np.asarray(values, np.uint8)[:n, None], r, axis=1)


KERNEL_WARPS = 4  # csrc/row_hist.cu: rows (warps) a CTA
KERNEL_CTAS = 132 * 6  # its grid's cap on a card of 132 SMs


def _kernel_model(regs, base, warps=None, start=0):
    """numpy model of csrc/row_hist.cu on rows that start `base` bytes into
    a 16-byte aligned buffer: (histograms, 256-entry presence). Warp g of
    `warps` (default: the kernel's grid, four a CTA, at most 792 CTAs)
    takes rows g, g + warps, ... Per row: the head up to the next 16-byte
    boundary and the tail after the last whole vector go one byte a lane,
    vector v to lane v % 32. A byte b below 64, zeros included, adds one
    to the lane's own 32-bit counter of b, word b * 32 + lane of its
    warp's counters (the lane's bank whatever b is); a byte of 64 or more
    is counted nowhere and sets its presence bit. The counters start at
    `start` (0 in the kernel; near 2^32 to show the wrap is harmless) and
    are never cleared: lane l's bins 2l and 2l + 1 are the difference of
    its sums over the 32 lanes from the end of the warp's previous row,
    modulo 2^32; the values below 64 present are the bins above 0."""
    n, r = regs.shape
    assert r < 1 << 31  # the wrapper's limit: R is an int
    if warps is None:
        warps = KERNEL_WARPS * min(-(-n // KERNEL_WARPS), KERNEL_CTAS)
    hist = np.zeros((n, 64), np.int64)
    present = np.zeros(256, bool)
    for g in range(warps):
        cnt = np.full((64, 32), start, np.uint64)  # [value, lane]
        sums = cnt.sum(1) % (1 << 32)  # the lanes' sums, a value
        for i in range(g, n, warps):
            addr = base + i * r
            head = min((16 - addr % 16) % 16, r)
            nvec = (r - head) // 16
            tail0 = head + nvec * 16
            assert head + (r - tail0) < 32
            pos = np.arange(head, tail0)
            lane = np.concatenate([(pos - head) // 16 % 32,
                                   np.arange(head + r - tail0)])
            pos = np.concatenate([pos, np.arange(head), np.arange(tail0, r)])
            assert len(pos) == r
            b = regs[i, pos].astype(np.int64)
            present[b[b >= 64]] = True
            ok = b < 64
            word = b[ok] * 32 + lane[ok]
            assert (word % 32 == lane[ok]).all()  # the lane's own bank
            np.add.at(cnt, (b[ok], lane[ok]), 1)
            cnt %= 1 << 32  # 32-bit counters
            now = cnt.sum(1) % (1 << 32)
            row = (now - sums) % (1 << 32)  # exact: a row has < 2^31 bytes
            sums = now
            assert row.max() < 1 << 31  # fits the int32 bin
            assert row.sum() + (~ok).sum() == r  # every byte counted once
            hist[i] = row
            present[:64] |= row > 0
    return hist, present


@pytest.mark.parametrize("kind,r,base", [
    pytest.param("skewed", 1024, 0, id="1024-0"),
    pytest.param("skewed", 1024, 1, id="1024-1"),
    pytest.param("skewed", 100, 0, id="100-0"),
    pytest.param("skewed", 48, 5, id="48-5"),
    pytest.param("skewed", 16384, 15, id="16384-15"),
    pytest.param("skewed", 40, 3, id="40-3"),
    pytest.param("dense", 16384, 0, id="dense-16384-0"),
    pytest.param("dense", 16384, 7, id="dense-16384-7"),
    pytest.param("dense", 100, 5, id="dense-100-5"),
    pytest.param("dense", 40, 3, id="dense-40-3"),
    pytest.param("one value", 16384, 0, id="one-value-16384-0"),
    pytest.param("one value", 16384, 9, id="one-value-16384-9")])
def test_kernel_model_matches_plain(kind, r, base):
    """The kernel's split, modelled in numpy, gives the plain version's
    histograms and present values: HLL-skewed rows (88% zero), dense
    genome-like rows (no zero byte at p=14) and rows of one value, of
    2^p, 100, 48 and 40 bytes (not 16 bytes a lane), from every kind of
    alignment; on the kernel's grid, on two warps (each warp's counters
    carried over its rows) and with the counters started 7 below 2^32."""
    rng = np.random.default_rng(r + base)
    n = 3 if r == 16384 else 9
    if kind == "skewed":
        regs = _hll_like(rng, n, r, 51)
        regs[1] = 0
        regs[2, -1] = 63
    elif kind == "dense":
        regs = _dense_like(rng, n, r)
        assert r < 1024 or (regs > 0).all()
    else:
        regs = _one_value(5, r)
    want, vals = screen.row_hist(torch.from_numpy(regs))
    for warps, start in ((None, 0), (2, 0), (2, (1 << 32) - 7)):
        hist, present = _kernel_model(regs, base, warps, start)
        np.testing.assert_array_equal(hist, want.numpy())
        assert tuple(np.nonzero(present)[0]) == vals
    bad = regs.copy()
    bad[0, 0] = 200  # the error word's bits: the presence of 64 and up
    _, present = _kernel_model(bad, base)
    assert present[200] and present[64:].sum() == 1


@pytest.mark.parametrize("p", [10, 14])
def test_lazy_cards_match_jax_bank(p):
    """A bank made without cards computes them at its first read:
    host_cards' bits, equal to the JAX SketchBank's (its jitted f64 MLE
    on the CPU backend)."""
    regs = _bank("hll built", p, 70 + p)
    names = [f"g{i}" for i in range(len(regs))]
    bank = SketchBank(names=names, regs=regs, p=p)
    assert not bank.has_cards()
    want = np.asarray(JBank(names=names, regs=regs, p=p).cards)
    np.testing.assert_array_equal(bank.cards.view(np.int64),
                                  want.view(np.int64))
    assert bank.has_cards()
    np.testing.assert_array_equal(
        SketchBank.from_arrays(names, regs, p).cards.view(np.int64),
        want.view(np.int64))
    given = np.linspace(1.0, 2.0, len(regs))
    assert SketchBank(names=names, regs=regs, p=p, cards=given).cards \
        is given


def _plans(crit, cards, seed=61, n=70, ti=16):
    if crit.startswith("hll"):
        jb = jax_bank_hll(n, 10, 6, seed)
    else:
        jb = jax_bank(n, 10, 16, seed)
    jp = jscreened.ScreenPlan(jb, JParams(tau=0.2, criterion=crit), ti)
    pb = port_bank(jb, cards=cards)
    pp = screened.ScreenPlan(pb, SelectionParams(tau=0.2, criterion=crit),
                             ti, device="cpu")
    return jb, jp, pb, pp


@pytest.mark.parametrize("crit", ["smh_a", "smh_only", "hll_a", "cb"])
@pytest.mark.parametrize("cards", [True, False])
def test_plan_matches_jax_plan(monkeypatch, crit, cards):
    """The plan sets a card-less bank's cards from its own row histograms
    (never through host_cards) to the JAX bank's bits, sorts by them as
    np.argsort(kind="stable") does, and its e, present values,
    fingerprints, aux values and bank read through its map equal the JAX
    plan's; the bank on the device is the rows in their own order and one
    zero row."""
    def no_host_cards(*_):
        raise AssertionError("the plan took host_cards")

    monkeypatch.setattr(tbank, "host_cards", no_host_cards)
    jb, jp, pb, pp = _plans(crit, cards)
    assert pb.has_cards()
    np.testing.assert_array_equal(pb.cards.view(np.int64),
                                  np.asarray(jb.cards).view(np.int64))
    np.testing.assert_array_equal(pp.order,
                                  np.argsort(jb.cards, kind="stable"))
    np.testing.assert_array_equal(pp.order, jp.order)
    np.testing.assert_array_equal(pp.e_s, jp.e_s)
    np.testing.assert_array_equal(pp.d_e.numpy(), np.asarray(jp.d_e))
    np.testing.assert_array_equal(pp.d_fp.numpy(), np.asarray(jp.d_fp))
    assert pp.values == jp.values
    assert pp.values_aux == getattr(jp, "values_aux", None)
    assert pp.cards_secs >= 0.0
    bank = np.zeros((pp.n + 1, 1 << 10), np.uint8)
    bank[:pp.n] = jb.regs
    np.testing.assert_array_equal(pp.d_bank.numpy(), bank)
    rows = pp.d_rows.numpy()
    assert rows.dtype == np.int32 and rows.shape == (pp.n_pad,)
    np.testing.assert_array_equal(rows[:pp.n], pp.order)
    assert (rows[pp.n:] == pp.n).all()
    np.testing.assert_array_equal(pp.d_bank[pp.d_rows.long()].numpy(),
                                  np.asarray(jp.d_regs))


def test_plan_present_values_equal_jax_bank_values():
    """The plan's values, before truncation, come from the histogram pass:
    the JAX bank_values of the bank's real rows (not the zero row)."""
    jb = jax_bank(40, 10, 16, 9)
    regs = np.array(jb.regs)
    regs += (regs == 0).astype(np.uint8)  # no zero registers at all
    bank = SketchBank(names=jb.names, regs=regs, p=10, aux=jb.aux,
                      aux_kind="smh", aux_param=16)
    hists, vals = screen.row_hist(torch.from_numpy(regs))
    assert vals == jscreen.bank_values(regs) and 0 not in vals
    plan = screened.ScreenPlan(bank, SelectionParams(tau=0.2), 16,
                               device="cpu")
    assert plan.values == screen.truncate_values(
        vals, float(plan.e_s.max()), 10)
    assert not plan.d_bank[-1].any()  # the zero row adds no value


@pytest.mark.parametrize("use_smh", [True, False])
def test_k1_plain_through_a_shuffled_map(use_smh):
    """K1's plain version through a shuffled row map (a bank in another
    order with one zero row, the padded positions mapped to it) equals it
    on the gathered sorted bank, through both entry points and the strip
    version with a slice of the map a side."""
    rng = np.random.default_rng(81 + use_smh)
    n, ti = 192, 64
    sorted_regs = rng.integers(0, 12, (n, 256), dtype=np.uint8)
    sorted_regs[-5:] = 0
    e = np.sort(rng.uniform(0, 5000, n)).astype(np.float32)
    e[:3] = 0.0
    aux = rng.integers(0, 1 << 63, size=(n, 16), dtype=np.uint64)
    aux[1::5] = aux[0]
    fp = torch.from_numpy(screened.band_fingerprints_np(aux, 4, 4))
    perm = rng.permutation(n).astype(np.int32)
    perm[-5:] = n
    bank = np.zeros((n + 1, 256), np.uint8)
    bank[perm[:-5]] = sorted_regs[:-5]
    d_bank, d_map, d_sorted, e_t = (torch.from_numpy(x) for x in
                                    (bank, perm, sorted_regs, e))
    np.testing.assert_array_equal(d_bank[d_map.long()].numpy(), sorted_regs)
    kw = dict(n_real=n - 5, tau_scr=0.4, tau_cb=0.35, p=8,
              values=screen.bank_values(sorted_regs), ti=ti, n_bands=4,
              use_cb=True, use_smh=use_smh)
    tiles = screen.launch_tiles([0, 0, 1, 2], [0, 2, 1, 2], True, "cpu")
    want = screen.screen_hits_fused(d_sorted, tiles, e_t, fp, **kw)
    assert int(want[1].sum()) > 0
    outs = [
        screen.screen_hits_fused(d_bank, tiles, e_t, fp, row_map=d_map,
                                 **kw),
        screen._screen_hits_fused_plain(d_bank, tiles.row_tiles,
                                        tiles.col_tiles, e_t, fp,
                                        row_map=d_map, **kw),
        screen.screen_hits_fused_strips(d_bank, d_bank, tiles, e_t, e_t, fp,
                                        fp, 0, 0, row_map=d_map,
                                        col_map=d_map, **kw)]
    st = screen.launch_tiles([0, 1], [1, 0], False, "cpu")
    r, c = slice(0, 128), slice(64, 192)
    strip_want = screen.screen_hits_fused_strips(
        d_sorted[r], d_sorted[c], st, e_t[r], e_t[c], fp[r], fp[c], 0, 64,
        **kw)
    strip_got = screen.screen_hits_fused_strips(
        d_bank, d_bank, st, e_t[r], e_t[c], fp[r], fp[c], 0, 64,
        row_map=d_map[r], col_map=d_map[c], **kw)
    for got in outs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(strip_got[0], strip_want[0])
    assert torch.equal(strip_got[1], strip_want[1])


@pytest.mark.parametrize("crit,tau", [
    ("smh_a", 0.2), ("hll_a", 0.2), ("hll_an", 0.2), ("cb", 0.2),
    ("baseline", 0.1),
])
@pytest.mark.parametrize("cards", [True, False])
def test_select_pairs_lines_match_jax(crit, tau, cards):
    """select_pairs through the screened engine on the CPU gives the JAX
    select_pairs_screened's pairs and Jaccards exactly, whether the bank
    came with cards or the plan computed them."""
    jb = (jax_bank_hll(20, 10, 6, 31) if crit.startswith("hll")
          else jax_bank(20, 10, 16, 17))
    want = jscreened.select_pairs_screened(
        jb, JParams(tau=tau, criterion=crit, block=64), ti=256, chunk=4)
    bank = port_bank(jb, cards=cards)
    stats = {}
    got = select_pairs(bank, SelectionParams(tau=tau, criterion=crit,
                                             engine="screened"),
                       device="cpu", stats=stats)
    assert got == want and len(got) > 0
    assert 0.0 <= stats["cards_secs"] <= stats["plan_secs"]
    assert bank.has_cards()
    np.testing.assert_array_equal(bank.cards.view(np.int64),
                                  np.asarray(jb.cards).view(np.int64))
