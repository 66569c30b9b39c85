"""The port's hll_a / hll_an path against the JAX package's: kernel K2's
plain version (screen_s_z) against the Pallas body in interpret mode, the
aux-union screen chunk, the plan's aux fields, the exact oracle, the
engine, the aux loader and the CLI. Inputs come from a numpy seed, or from
sketch files the tests write, and go through both packages.

Tolerance: none. S and Z are bit-equal because both sides add the exact
integer CDFs w_v * CDF_v in ascending v; that holds while the register
axis fits one Pallas r_sub block (p <= 10 at ti = tj = 64, the default
r_sub), which is where these tests stay. Hit masks (compared as bool),
counts, pair sets and f64 Jaccard values are equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_banks import (jax_bank_hll, one_torch_thread,  # noqa: F401
                         port_bank, rounded)

from cuda_selection_criteria_tpu.cli import selection as jcli
from cuda_selection_criteria_tpu.models.bank import SketchBank as JBank
from cuda_selection_criteria_tpu.ops import hll_build as jhll_build
from cuda_selection_criteria_tpu.ops import screen as jscreen
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu.utils import hostref as jhostref
from cuda_selection_criteria_tpu_torch.cli import selection as cli
from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.models.bank import host_cards
from cuda_selection_criteria_tpu_torch.ops import screen
from cuda_selection_criteria_tpu_torch.parallel import screened
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams, format_results, select_pairs)
from cuda_selection_criteria_tpu_torch.utils import formats, hostref, synth

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (lo, hi) of the register draws, truncate, separate column bank, tj
K2_CASES = {
    "zeros": (0, 13, False, False, 64),
    "no_zeros": (3, 15, False, False, 64),
    "truncated": (0, 26, True, False, 64),
    "regs_cols": (0, 13, False, True, 64),
    "ti_ne_tj": (1, 12, False, True, 128),
}


@pytest.mark.parametrize("p", [6, 8])
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_screen_s_z_plain_matches_pallas(p, case):
    """K2's plain version == the Pallas _weighted_cdf_sum body in interpret
    mode == the JAX package's portable path, S and Z bit-for-bit."""
    lo, hi, truncate, sep_cols, tj = K2_CASES[case]
    ti = 64
    rng = np.random.default_rng(100 * p + lo + hi + tj)
    regs = rng.integers(lo, hi, size=(192, 1 << p), dtype=np.uint8)
    cols = (rng.integers(lo, hi, size=(256, 1 << p), dtype=np.uint8)
            if sep_cols else regs)
    rows = np.array([0, 2, 1, 0], np.int32)
    ctiles = np.array([0, 1, 0, 1], np.int32)
    vals = screen.bank_values(np.concatenate([regs, cols]))
    if truncate:
        vals = screen.truncate_values(vals, 40.0, p)
        assert len(vals) < hi - lo
    kw = dict(ti=ti, tj=tj)
    s, z = screen._screen_s_z_plain(
        torch.from_numpy(regs), torch.from_numpy(rows),
        torch.from_numpy(ctiles), p, vals,
        regs_cols=torch.from_numpy(cols) if sep_cols else None, **kw)
    jargs = (jnp.asarray(regs), jnp.asarray(rows), jnp.asarray(ctiles), p,
             vals)
    jcols = jnp.asarray(cols) if sep_cols else None
    for interpret in (True, None):
        js, jz = jscreen.screen_s_z(*jargs, interpret=interpret,
                                    regs_cols=jcols, **kw)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert (z is None) == (jz is None) == (vals[0] != 0)
        if z is not None:
            np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    assert s.shape == (4, ti, tj)
    # the public entry point runs the plain version on CPU tensors
    s2, z2 = screen.screen_s_z(
        torch.from_numpy(regs), torch.from_numpy(rows),
        torch.from_numpy(ctiles), p, vals,
        regs_cols=torch.from_numpy(cols) if sep_cols else None, **kw)
    assert torch.equal(s2, s) and (z2 is None or torch.equal(z2, z))


def test_screen_s_z_rejects_unsupported_device():
    """K2's argument checks run before any kernel is touched; a meta
    tensor reaches them on a machine without a card."""
    regs = torch.zeros((128, 256), dtype=torch.uint8, device="meta")
    tiles = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="screen_s_z: unsupported device"):
        screen.screen_s_z(regs, tiles, tiles, 8, (0, 1), ti=64, tj=64)


@pytest.mark.parametrize("crit", ["hll_a", "hll_an"])
@pytest.mark.parametrize("order_n", [1, 2, 3])
def test_hll_aux_threshold_coef_matches_jax(crit, order_n):
    seen_none = False
    for tau in (0.02, 0.1, 0.5, 0.9, 0.99):
        for zs in (0.0, 0.05, 0.127, 0.2, 0.6, 0.9):
            got = screened.hll_aux_threshold_coef(crit, tau, zs, order_n)
            want = jscreened.hll_aux_threshold_coef(crit, tau, zs, order_n)
            assert got == want
            seen_none |= got is None
    assert seen_none == (crit == "hll_an")
    assert screened.SCREEN_DELTA_AUX == jscreened.SCREEN_DELTA_AUX


def _hll_plans(crit, tau, ti=64, n=160, seed=61, **kw):
    jb = jax_bank_hll(n, 10, 6, seed)
    return (jscreened.ScreenPlan(jb, JParams(tau=tau, criterion=crit, **kw),
                                 ti),
            screened.ScreenPlan(port_bank(jb), SelectionParams(
                tau=tau, criterion=crit, **kw), ti, device="cpu"))


@pytest.mark.parametrize("crit,tau", [
    ("hll_a", 0.2), ("hll_an", 0.2), ("hll_a", 0.6),
])
def test_plan_aux_fields_match_jax(crit, tau):
    jp, pp = _hll_plans(crit, tau)
    assert pp.values_aux == jp.values_aux and len(pp.values_aux) >= 2
    assert pp.coef_aux == np.float32(jp.coef_aux)
    assert pp.coef_aux.dtype == np.float32
    np.testing.assert_array_equal(pp.d_aux_regs.numpy(),
                                  np.asarray(jp.d_aux_regs))
    assert pp.d_aux_regs.shape == (pp.n_pad, 64)
    assert pp.values == jp.values and pp.use_cb and not pp.use_smh


def test_plan_without_aux_gate_matches_jax():
    """hll_an at a z-score where 1 + tau - 2s <= 0: the aux gate cannot
    prune, so both plans keep the plain K1 chunk."""
    jp, pp = _hll_plans("hll_an", 0.1, z_score=5.0)
    assert jp.coef_aux is None and jp.values_aux is None
    assert pp.coef_aux is None and pp.values_aux is None
    assert pp.d_aux_regs is None
    rows, cols = pp.schedule()
    hits, counts = pp.screen_chunk(rows, cols)
    want = screened._screen_chunk(
        pp.d_bank, screen.launch_tiles(rows, cols, True, pp.device), pp.d_e,
        pp.d_fp, pp.n, pp.tau_scr, pp.tau_cb, pp.bank.p, pp.values, pp.ti, 1,
        True, False, pp.d_rows)
    assert torch.equal(hits, want[0]) and torch.equal(counts, want[1])


@pytest.mark.parametrize("crit,tau,z_score", [
    ("hll_a", 0.2, 1.96), ("hll_an", 0.2, 0.5), ("hll_a", 0.05, 1.96),
])
def test_screen_chunk_hllaux_matches_jax(crit, tau, z_score):
    """p=10 / p_aux=6 at ti=64 over the whole triangle: hit masks (as
    bool) and per-tile counts bit-equal; the aux gate removes hits."""
    jp, pp = _hll_plans(crit, tau, z_score=z_score)
    rows, cols = pp.schedule()
    assert len(rows) == 6
    hits, counts = pp.screen_chunk(rows, cols)
    jhits, jcounts = jp.screen_chunk(rows, cols)
    np.testing.assert_array_equal(hits.numpy().astype(bool),
                                  np.asarray(jhits).astype(bool))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.dtype == torch.int32
    primary, _ = screened._screen_chunk(
        pp.d_bank, screen.launch_tiles(rows, cols, True, pp.device), pp.d_e,
        pp.d_fp, pp.n, pp.tau_scr, pp.tau_cb, pp.bank.p, pp.values, pp.ti, 1,
        True, False, pp.d_rows)
    assert 0 < int(counts.sum()) < int(primary.sum())


def _oracle_inputs(seed=23, n=30, p=8, p_aux=6):
    rng = np.random.default_rng(seed)
    regs = rng.integers(0, 14, size=(n, 1 << p), dtype=np.uint8)
    aux = rng.integers(0, 14, size=(n, 1 << p_aux), dtype=np.uint8)
    regs[1::3] = regs[0]  # planted near-duplicates
    regs[1::3, :4] += 1
    aux[1::3] = aux[0]
    aux[2::3, :8] = aux[0, :8]
    return regs, np.trunc(host_cards(regs, p)), aux


@pytest.mark.parametrize("crit", ["hll_a", "hll_an"])
@pytest.mark.parametrize("tau,z_score,order_n", [
    (0.3, 1.96, 1), (0.6, 1.0, 2), (0.05, 2.5, 1),
])
def test_oracle_hll_gates_match_jax(crit, tau, z_score, order_n):
    """confirm_pairs and evaluate of both oracles on hll_a / hll_an:
    identical pair sets and f64 Jaccard values; the aux gate rejects some
    pairs that pass CB."""
    p, p_aux = 8, 6
    regs, e, aux = _oracle_inputs()
    kw = dict(aux=aux, aux_param=p_aux, criterion=crit, tau=tau,
              z_score=z_score, order_n=order_n)
    n = len(e)
    pairs = [(i, k) for i in range(n - 1) for k in range(i + 1, n)]
    oracle = hostref.PairOracle(p, regs, e, **kw)
    joracle = jhostref.PairOracle(p, regs, e, **kw)
    assert oracle.zs == joracle.zs
    got = oracle.confirm_pairs(pairs, batch=64)
    assert got == joracle.confirm_pairs(pairs, batch=64)
    gates = [oracle.gates_pass(i, k) for i, k in pairs]
    assert gates == [joracle.gates_pass(i, k) for i, k in pairs]
    want = [(i, k, j) for (i, k) in pairs
            for sel, j in [oracle.evaluate(i, k)] if sel]
    assert got == want and len(got) > 0
    cb = hostref.PairOracle(p, regs, e, criterion="cb", tau=tau)
    assert sum(gates) < sum(cb.gates_pass(i, k) for i, k in pairs)


def _planted_hll_bank(n=240, p=10, p_aux=6, seed=29, n_dups=20):
    """A bank of the real register distribution, primary and aux HLLs
    from the same hashes, planted near-duplicates: the JAX package's bank
    and the port's, carrying the same arrays."""
    rng = np.random.default_rng(seed)
    regs, aux = synth.synthetic_hll_banks(n, rng.integers(500, 900, n),
                                          (p, p_aux), rng)
    synth.plant_near_duplicates(regs, aux, rng, n_dups)
    names = [f"g{i:03d}" for i in range(n)]
    cards = host_cards(regs, p)
    jb = JBank(names=names, p=p, regs=regs, cards=cards, aux=aux,
               aux_kind="hll", aux_param=p_aux)
    return jb, port_bank(jb)


@pytest.mark.parametrize("crit", ["hll_a", "hll_an"])
@pytest.mark.parametrize("bank_kind,tau", [("items", 0.2), ("planted", 0.9)])
def test_select_pairs_hll_matches_jax_and_host(crit, bank_kind, tau):
    """tests/test_screen.py::test_screened_engine_matches_host_hll_aux on
    the port, and a planted bank of the real register distribution."""
    if bank_kind == "items":
        jb = jax_bank_hll(20, 10, 6, 31)
        bank = port_bank(jb)
        ti = 256
    else:
        jb, bank = _planted_hll_bank()
        ti = 64
    host = jhostref.select_pairs_host(jb, tau, crit)
    want = jscreened.select_pairs_screened(
        jb, JParams(tau=tau, criterion=crit, block=64), ti=ti, chunk=4)
    stats = {}
    got = select_pairs(bank, SelectionParams(tau=tau, criterion=crit,
                                             engine="screened"),
                       device="cpu", stats=stats)
    assert got == want
    assert rounded(got) == rounded(host)
    assert got == hostref.select_pairs_host(bank, tau, crit)
    assert screened.select_pairs_screened(
        bank, SelectionParams(tau=tau, criterion=crit), ti=ti, chunk=4,
        device="cpu") == got
    assert stats["confirmed"] == len(got) and stats["candidates"] >= len(got)
    assert len(got) >= (15 if bank_kind == "planted" else 1)


@pytest.mark.parametrize("p", [6, 8, 14])
def test_synthetic_hll_banks_match_jax_index_rank(p):
    """The paired synthetic build reduces each hash with the reference's
    index/rank rule at every precision (JAX hll_index_rank + max)."""
    rng = np.random.default_rng(p)
    h = rng.integers(0, 1 << 64, size=(3, 700), dtype=np.uint64)
    valid = np.arange(700)[None, :] < np.array([[700], [350], [10]])
    got = synth._reduce_hashes(h, valid, p)
    idx, rank = jhll_build.hll_index_rank(jnp.asarray(h.ravel()), p)
    want = np.zeros((3, 1 << p), np.int64)
    flat = np.repeat(np.arange(3), 700) * (1 << p) + np.asarray(idx)
    np.maximum.at(want.reshape(-1), flat[valid.ravel()],
                  np.asarray(rank)[valid.ravel()])
    np.testing.assert_array_equal(got, want)


def test_synthetic_hll_banks_share_draws():
    """Each bank of synthetic_hll_banks equals synthetic_regs from the same
    seed at its precision: the draws do not depend on the precisions."""
    items = np.random.default_rng(1).integers(100, 3000, 50)
    regs, aux = synth.synthetic_hll_banks(50, items, (10, 8),
                                          np.random.default_rng(2), chunk=16)
    np.testing.assert_array_equal(
        regs, synth.synthetic_regs(50, items, 10, np.random.default_rng(2),
                                   chunk=16))
    np.testing.assert_array_equal(
        aux, synth.synthetic_regs(50, items, 8, np.random.default_rng(2),
                                  chunk=16))


def test_bank_from_arrays_carries_hll_aux():
    jb = jax_bank_hll(12, 10, 6, 3)
    bank = port_bank(jb)
    np.testing.assert_array_equal(bank.aux, jb.aux)
    assert bank.aux.dtype == np.uint8 and bank.aux.shape == (12, 64)
    assert (bank.aux_kind, bank.aux_param) == ("hll", 6)
    np.testing.assert_array_equal(port_bank(jb, cards=False).cards, jb.cards)


@pytest.fixture(scope="module")
def hll_sketch_list(tmp_path_factory):
    """24 genomes at p=14 with .hll_8 aux sketches from the same hashes,
    in two size classes, near-duplicates planted."""
    d = tmp_path_factory.mktemp("hll_sketches")
    rng = np.random.default_rng(4096)
    regs, aux = synth.synthetic_hll_banks(
        24, np.repeat([1500, 3000], 12), (14, 8), rng)
    synth.plant_near_duplicates(regs, aux, rng, 5)
    names = [str(d / f"g{i:02d}.fna.gz") for i in range(24)]
    for name, r, a in zip(names, regs, aux):
        formats.write_hll(name + ".hll", 14, r)
        formats.write_hll(name + ".hll_8", 8, a)
    lst = d / "list.txt"
    lst.write_text("\n".join(names) + "\n")
    return str(lst), names, aux


@pytest.mark.parametrize("crit", ["hll_a", "hll_an"])
def test_from_sketch_files_hll_matches_jax(hll_sketch_list, crit):
    _, names, aux = hll_sketch_list
    bank = SketchBank.from_sketch_files(names, criterion=crit, aux_bytes=256)
    jb = JBank.from_sketch_files(names, criterion=crit, aux_bytes=256)
    np.testing.assert_array_equal(bank.aux, jb.aux)
    np.testing.assert_array_equal(bank.aux, aux)
    np.testing.assert_array_equal(bank.regs, jb.regs)
    np.testing.assert_array_equal(bank.cards, jb.cards)
    assert (bank.aux_kind, bank.aux_param) == (jb.aux_kind, jb.aux_param) \
        == ("hll", 8)


@pytest.mark.parametrize("crit", ["hll_a", "hll_an"])
def test_cli_hll_matches_jax_and_host(hll_sketch_list, crit, capsys):
    lst, names, _ = hll_sketch_list
    argv = ["-l", lst, "-a", "256", "-h", "0.9", "-c", crit]
    outs = []
    for engine in ("screened", "dense"):
        capsys.readouterr()
        assert cli.main(argv + ["--device", "cpu", "--engine", engine]) == 0
        outs.append(capsys.readouterr().out)
    got = outs[0]
    assert outs[1] == got
    assert jcli.main(argv) == 0
    assert got == capsys.readouterr().out
    bank = SketchBank.from_sketch_files(names, criterion=crit)
    host = hostref.select_pairs_host(bank, 0.9, crit)
    assert got.splitlines() == format_results(host)
    assert len(host) >= 3
