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
  lane's 16-bit counters of the non-zero values, bin 0 from the row's
  length) gives the same histograms and present values;
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


def _kernel_model(regs, base):
    """numpy model of csrc/row_hist.cu on rows that start `base` bytes into
    a 16-byte aligned buffer: (histograms, 256-entry presence). Per row:
    the head up to the next 16-byte boundary and the tail after the last
    whole vector go one byte a lane, vector v to lane v % 32; a lane counts
    each non-zero value below 64 in the 16-bit half (v & 1) of its word
    v >> 1, and bytes of 64 or more apart (setting their presence bit);
    bin 0 is the row's length less every byte counted; the values below
    64 present are the bins above 0."""
    n, r = regs.shape
    hist = np.zeros((n, 64), np.int64)
    present = np.zeros(256, bool)
    for i in range(n):
        addr = base + i * r
        head = min((16 - addr % 16) % 16, r)
        nvec = (r - head) // 16
        tail0 = head + nvec * 16
        halves = np.zeros((32, 64), np.int64)  # [lane, value]
        big = 0
        lanes = [(v % 32, head + 16 * v + k) for v in range(nvec)
                 for k in range(16)]
        lanes += list(enumerate(list(range(head)) + list(range(tail0, r))))
        assert len(lanes) == r and head + (r - tail0) < 32
        for lane, pos in lanes:
            b = int(regs[i, pos])
            if b >= 64:
                big += 1
                present[b] = True
            elif b:
                halves[lane, b] += 1
        assert halves.max() < 1 << 16  # no half carries into its neighbour
        hist[i] = halves.sum(0)
        hist[i, 0] = r - hist[i].sum() - big
        present[:64] |= hist[i] > 0
    return hist, present


@pytest.mark.parametrize("r,base", [(1024, 0), (1024, 1), (100, 0),
                                    (48, 5), (16384, 15), (40, 3)])
def test_kernel_model_matches_plain(r, base):
    """The kernel's split, modelled in numpy, gives the plain version's
    histograms and present values: rows of 2^p, 100, 48 and 40 bytes
    (not 16 bytes a lane), from every kind of alignment."""
    rng = np.random.default_rng(r + base)
    n = 3 if r == 16384 else 9
    regs = _hll_like(rng, n, r, 51)
    regs[1] = 0
    regs[2, -1] = 63
    hist, present = _kernel_model(regs, base)
    want, vals = screen.row_hist(torch.from_numpy(regs))
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
