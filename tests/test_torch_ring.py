"""The port's ring engine (parallel/ring.py) and K1's strip variant
(ops/screen.screen_hits_fused_strips) against the JAX package's, on banks
made once from a numpy seed. The port runs on meshes of CPU devices that
repeat one device (the JAX package runs eight virtual CPU devices), with
strips small enough that most of them hold real rows, so the strips' bases
are non-zero and the triangle crosses strips. Every comparison is exact:
masks and counts bit-equal, output lines equal after torch_banks.rounded."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_ring import _ladder_bank
from torch_banks import (jax_bank, jax_bank_hll, one_torch_thread,  # noqa
                         port_bank, rounded)

from cuda_selection_criteria_tpu.ops import screen as jscreen
from cuda_selection_criteria_tpu.parallel import ring as jring
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu_torch.ops import screen
from cuda_selection_criteria_tpu_torch.parallel import ring, screened
from cuda_selection_criteria_tpu_torch.parallel.mesh import row_mesh
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)
from cuda_selection_criteria_tpu_torch.utils.hostref import select_pairs_host

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P, TI, STRIP = 8, 32, 96
# (row_base, col_base): the reference test's, equal bases, a row strip
# that starts after the column strip (the triangle's edge inside a tile),
# and a row strip wholly after it (every pair below the triangle)
BASES = [(96, 192), (96, 96), (120, 100), (192, 96)]


def _strip_inputs(seed=77, zeros=True):
    """tests/test_ring.py::test_fused_strips_matches_ring_post's inputs:
    two 96-row strips at p=8, sorted cardinalities with two empty columns,
    LSH fingerprints of 4 bands; with zeros=False no register is 0."""
    rng = np.random.default_rng(seed)
    lo = 0 if zeros else 1
    regs_r = rng.integers(lo, 11, size=(STRIP, 1 << P), dtype=np.uint8)
    regs_c = rng.integers(lo, 11, size=(STRIP, 1 << P), dtype=np.uint8)
    e_r = np.sort(rng.uniform(0, 4000, STRIP)).astype(np.float32)
    e_c = np.sort(rng.uniform(0, 4000, STRIP)).astype(np.float32)
    e_c[:2] = 0.0
    aux_r = rng.integers(0, 1 << 63, (STRIP, 16), dtype=np.uint64)
    aux_c = rng.integers(0, 1 << 63, (STRIP, 16), dtype=np.uint64)
    # shared bands: row k with column k + 3 (k = 0 mod 6) and k + 24
    # (k = 3 mod 6), on both sides of the triangle's edge for every base
    for k in range(0, STRIP - 24, 3):
        aux_c[k + (3 if k % 6 == 0 else 24)] = aux_r[k]
    fp_r = screened.band_fingerprints_np(aux_r, 4, 4)
    fp_c = screened.band_fingerprints_np(aux_c, 4, 4)
    vals = tuple(sorted(set(screen.bank_values(regs_r))
                        | set(screen.bank_values(regs_c))))
    return regs_r, regs_c, e_r, e_c, fp_r, fp_c, vals


R_TILES = np.array([0, 1, 2, 2], np.int32)
C_TILES = np.array([1, 0, 2, 1], np.int32)


@pytest.mark.parametrize("bases", BASES)
@pytest.mark.parametrize("use_cb,use_smh", [(True, True), (False, False),
                                            (True, False)])
def test_plain_strips_match_jax(bases, use_cb, use_smh):
    """The plain strip K1 bit-equal to the reference's Pallas strip kernel
    (interpret mode) and to its two-pass form (screen_s_z + _ring_post)."""
    regs_r, regs_c, e_r, e_c, fp_r, fp_c, vals = _strip_inputs()
    row_base, col_base = bases
    n_real = col_base + 88
    tau_scr, tau_cb = 0.3, 0.25
    got_h, got_c = screen.screen_hits_fused_strips(
        torch.from_numpy(regs_r), torch.from_numpy(regs_c),
        screen.launch_tiles(R_TILES, C_TILES, False, "cpu"),
        *[torch.from_numpy(x) for x in (e_r, e_c, fp_r, fp_c)],
        row_base, col_base, n_real, tau_scr, tau_cb, P, vals, TI, 4, use_cb,
        use_smh)
    j = [jnp.asarray(x) for x in (regs_r, regs_c, R_TILES, C_TILES, e_r, e_c,
                                  fp_r, fp_c)]
    jb = (jnp.int32(row_base), jnp.int32(col_base), jnp.int32(n_real),
          jnp.float32(tau_scr), jnp.float32(tau_cb))
    want_h, want_c = jscreen.screen_hits_fused_strips(
        *j, *jb, P, vals, TI, 4, use_cb, use_smh, interpret=True)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    ss, zz = jscreen.screen_s_z(j[0], j[2], j[3], P, vals, ti=TI, tj=TI,
                                regs_cols=j[1])
    post = jring._ring_post(ss, zz, j[4], j[5], j[6], j[7], jb[0], jb[1],
                            j[2], j[3], jb[2], jb[3], jb[4], P, 4, TI,
                            use_cb, use_smh)
    np.testing.assert_array_equal(got_h.numpy().astype(bool),
                                  np.asarray(post))
    if bases == (192, 96):
        assert int(got_c.sum()) == 0
    elif not use_smh or row_base <= col_base:
        # (at (120, 100) none of the planted band pairs is above the edge)
        assert 0 < int(got_c.sum()) < len(R_TILES) * TI * TI


@pytest.mark.parametrize("zeros", [True, False])
def test_ring_post_and_gate_counts_match_jax(zeros):
    """_ring_post on the port's K2 (S, Z with a column bank) and
    _ring_gate_counts, bit-equal to the reference's, at every base pair."""
    regs_r, regs_c, e_r, e_c, fp_r, fp_c, vals = _strip_inputs(81, zeros)
    t = [torch.from_numpy(x) for x in (regs_r, regs_c, R_TILES, C_TILES, e_r,
                                       e_c, fp_r, fp_c)]
    j = [jnp.asarray(x) for x in (regs_r, regs_c, R_TILES, C_TILES, e_r, e_c,
                                  fp_r, fp_c)]
    s, z = screen.screen_s_z(t[0], t[2], t[3], P, vals, ti=TI, tj=TI,
                             regs_cols=t[1])
    js, jz = jscreen.screen_s_z(j[0], j[2], j[3], P, vals, ti=TI, tj=TI,
                                regs_cols=j[1])
    assert (z is None) == (not zeros) == (jz is None)
    for row_base, col_base in BASES:
        n_real = col_base + 70
        for use_cb, use_smh in ((True, True), (False, True), (True, False)):
            got = ring._ring_post(s, z, t[4], t[5], t[6], t[7], row_base,
                                  col_base, t[2], t[3], n_real, 0.3, 0.25, P,
                                  4, TI, use_cb, use_smh)
            want = jring._ring_post(
                js, jz, j[4], j[5], j[6], j[7], jnp.int32(row_base),
                jnp.int32(col_base), j[2], j[3], jnp.int32(n_real),
                jnp.float32(0.3), jnp.float32(0.25), P, 4, TI, use_cb,
                use_smh)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            got = ring._ring_gate_counts(t[4], t[5], t[6], t[7], row_base,
                                         col_base, t[2], t[3], n_real,
                                         np.float32(0.25), 4, TI, use_cb,
                                         use_smh)
            want = jring._ring_gate_counts(
                j[4], j[5], j[6], j[7], jnp.int32(row_base),
                jnp.int32(col_base), j[2], j[3], jnp.int32(n_real),
                jnp.float32(0.25), 4, TI, use_cb, use_smh)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("zeros", [True, False])
def test_ring_aux_pass_matches_jax(zeros):
    """The strip-pair aux-union gate on K2's (S_a, Z_a) at p_aux=6."""
    rng = np.random.default_rng(5 + zeros)
    lo = 0 if zeros else 1
    aux_r = rng.integers(lo, 9, size=(STRIP, 64), dtype=np.uint8)
    aux_c = rng.integers(lo, 9, size=(STRIP, 64), dtype=np.uint8)
    e_r = np.sort(rng.uniform(0, 3000, STRIP)).astype(np.float32)
    e_c = np.sort(rng.uniform(0, 3000, STRIP)).astype(np.float32)
    vals = tuple(sorted(set(screen.bank_values(aux_r))
                        | set(screen.bank_values(aux_c))))
    t = [torch.from_numpy(x) for x in (aux_r, aux_c, R_TILES, C_TILES)]
    j = [jnp.asarray(x) for x in (aux_r, aux_c, R_TILES, C_TILES)]
    s, z = screen.screen_s_z(t[0], t[2], t[3], 6, vals, ti=TI, tj=TI,
                             regs_cols=t[1])
    js, jz = jscreen.screen_s_z(j[0], j[2], j[3], 6, vals, ti=TI, tj=TI,
                                regs_cols=j[1])
    seen = set()
    for coef in (0.2, 0.6, 1.5):
        got = ring._ring_aux_pass(s, z, torch.from_numpy(e_r),
                                  torch.from_numpy(e_c), t[2], t[3],
                                  np.float32(coef), 6, TI)
        want = jring._ring_aux_pass(js, jz, jnp.asarray(e_r),
                                    jnp.asarray(e_c), j[2], j[3],
                                    jnp.float32(coef), 6, TI)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        seen |= set(np.unique(got.numpy()).tolist())
    assert seen == {False, True}


def test_strip_profile_matches_jax():
    rng = np.random.default_rng(3)
    n, n_dev, strip = 130, 4, 48  # strip 3 holds no real row
    e_p = np.zeros(n_dev * strip, np.float32)
    e_p[:n] = np.sort(np.trunc(rng.uniform(0, 900, n)))
    e_p[:60] = 0.0  # a strip with no positive cardinality
    got = ring._strip_profile(e_p, n, n_dev, strip)
    want = jring._strip_profile(e_p, n, n_dev, strip)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not got[0][3] and np.isinf(got[2][0])


CRITERIA = [("smh_a", 0.15), ("smh_only", 0.15), ("cb", 0.15),
            ("baseline", 0.15), ("hll_a", 0.1), ("hll_an", 0.1)]


@functools.lru_cache(maxsize=None)
def _jax_ring(crit, tau):
    """(JAX bank, its ring engine's lines on the 8 virtual devices)."""
    jb = (jax_bank_hll(48, 10, 6, 31) if crit.startswith("hll")
          else jax_bank(48, 10, 16, 47))
    return jb, rounded(jring.select_pairs_ring(
        jb, JParams(tau=tau, criterion=crit), ti=8))


@pytest.mark.parametrize("n_dev", [1, 3, 8])
@pytest.mark.parametrize("crit,tau", CRITERIA)
def test_ring_matches_jax_host_and_screened(crit, tau, n_dev):
    """select_pairs_ring on 1, 3 and 8 CPU devices (one device repeated),
    strips of 8 rows: lines equal to the reference ring's, the host
    reference's and the port's screened engine's."""
    jb, want = _jax_ring(crit, tau)
    bank = port_bank(jb)
    params = SelectionParams(tau=tau, criterion=crit)
    stats = {}
    got = rounded(ring.select_pairs_ring(
        bank, params, mesh=row_mesh(["cpu"] * n_dev), ti=8, stats=stats))
    host = rounded(select_pairs_host(
        bank, tau, crit, apply_cb=crit not in ("baseline", "smh_only")))
    assert got == want == host and len(got) >= 4
    assert rounded(screened.select_pairs_screened(
        bank, params, ti=16, chunk=8, device="cpu")) == got
    assert stats["steps_total"] == n_dev and stats["dispatches"] > 0
    assert stats["strip"] == -(-48 // (8 * n_dev)) * 8


def test_ring_pair_coverage_is_exhaustive():
    """tests/test_ring.py:37-50 on the port: baseline at a tau so small
    that the bound passes nearly every pair, across every strip pair: the
    ring's candidates are the single-device engine's (the whole triangle
    but the pairs with an empty column) and the output is the host's."""
    bank = port_bank(jax_bank(40, 10, 16, 13))
    params = SelectionParams(tau=1e-6, criterion="baseline")
    stats, single = {}, {}
    got = ring.select_pairs_ring(bank, params, mesh=row_mesh(["cpu"] * 5),
                                 ti=8, stats=stats)
    screened.select_pairs_screened(bank, params, ti=8, device="cpu",
                                   stats=single)
    assert stats["candidates"] == single["candidates"] >= 40 * 39 // 2 - 2
    assert rounded(got) == rounded(select_pairs_host(bank, 1e-6, "baseline",
                                                     apply_cb=False))
    assert len(got) > 0


def test_ring_streams_masks_and_skips_dead_steps():
    """tests/test_ring.py:65-86 on the port: a cardinality ladder makes
    far-apart strip pairs CB-dead, so some ring steps never run, and with
    one chunk a wave a position's pending masks stay within
    chunk_tiles * ti^2 bytes."""
    jb = _ladder_bank(512, np.random.default_rng(3), n_dups=12)
    bank = port_bank(jb)
    params = SelectionParams(tau=0.8, criterion="cb")
    stats = {}
    got = ring.select_pairs_ring(bank, params, mesh=row_mesh(["cpu"] * 8),
                                 ti=32, chunk_tiles=2, stats=stats, wave=1)
    want = rounded(jring.select_pairs_ring(jb, JParams(tau=0.8,
                                                       criterion="cb"),
                                           ti=32, chunk_tiles=2))
    assert rounded(got) == want == rounded(select_pairs_host(bank, 0.8,
                                                             "cb"))
    assert len(got) > 0
    assert 0 < stats["max_device_mask_bytes"] <= 2 * 32 * 32
    assert stats["max_wave_alloc_bytes"] is None  # no CUDA device
    assert 0 < stats["steps_run"] < stats["steps_total"]
    assert 0 < stats["tiles_gate_live"] <= stats["tiles_dispatched"]
    for key in ("screen_secs", "gate_secs", "confirm_secs", "upload_secs"):
        assert stats[key] >= 0.0


@pytest.mark.parametrize("wave", [1, 3, 64])
def test_ring_reads_each_wave_of_chunks(wave):
    """Counts and hits are read every `wave` chunks of a step: a mesh
    position's pending masks stay within wave * chunk_tiles * ti^2 bytes,
    grow with the wave while a step has more chunks than it, and the lines
    stay the host's whatever the wave."""
    bank = port_bank(jax_bank(256, 8, 16, 61))
    params = SelectionParams(tau=1e-6, criterion="baseline")
    stats = {}
    got = ring.select_pairs_ring(bank, params, mesh=row_mesh(["cpu"] * 2),
                                 ti=16, chunk_tiles=4, stats=stats,
                                 wave=wave)
    assert rounded(got) == rounded(select_pairs_host(bank, 1e-6, "baseline",
                                                     apply_cb=False))
    launch = 4 * 16 * 16  # chunk_tiles * ti^2 int8 hits
    held = stats["max_device_mask_bytes"]
    if wave < 64:
        assert held == wave * launch
    else:  # a step of more than 3 chunks holds them all at once
        assert 3 * launch < held <= wave * launch


def test_ring_gate_prune_kills_all_tiles_exactly():
    """tests/test_ring.py:147-164 on the port: with every aux row distinct
    the fingerprint gate rejects every pair, so no tile reaches K1."""
    jb = jax_bank(24, 10, 16, 53)
    jb.aux[:] = np.random.default_rng(53).integers(
        0, 1 << 63, size=jb.aux.shape, dtype=np.uint64)
    bank = port_bank(jb)
    params = SelectionParams(tau=0.9, criterion="smh_a")
    stats = {}
    got = ring.select_pairs_ring(bank, params, mesh=row_mesh(["cpu"] * 3),
                                 ti=8, stats=stats)
    assert rounded(got) == rounded(select_pairs_host(bank, 0.9, "smh_a"))
    assert stats["tiles_gate_live"] == 0 and stats["tiles_dispatched"] > 0
    assert stats["dispatches"] == 0


def test_ring_single_value_bank_takes_two_pass_form():
    """A bank with one present register value (constant S and Z): the
    step takes screen_s_z + _ring_post instead of K1, as the reference."""
    regs = np.full((30, 64), 3, np.uint8)
    aux = np.random.default_rng(2).integers(0, 1 << 62, (30, 16),
                                            dtype=np.uint64)
    aux[1::4] = aux[0]
    from cuda_selection_criteria_tpu_torch.models import SketchBank

    bank = SketchBank.from_arrays(
        names=[f"s{i}" for i in range(30)], regs=regs, p=6, aux=aux,
        aux_kind="smh", aux_param=16)
    params = SelectionParams(tau=0.5, criterion="smh_a")
    got = ring.select_pairs_ring(bank, params, mesh=row_mesh(["cpu"] * 4),
                                 ti=4)
    assert got == select_pairs_host(bank, 0.5, "smh_a") and len(got) > 0


def test_strip_moves_share_tensors_on_a_repeated_device():
    """Rotating strips over a mesh that repeats one device moves no data
    (the same tensors), and rotate hands device d + 1 device d's strip."""
    strips = [ring.Strip(torch.full((4, 8), d, dtype=torch.uint8), None,
                         torch.zeros(4), torch.zeros((4, 1), dtype=torch.int32),
                         4 * d) for d in range(3)]
    _, _, rotate = ring.make_ring_fns(row_mesh(["cpu"] * 3), 3, (0, 1), 4,
                                      1, True, False)
    moved = rotate(strips)
    assert [s.base for s in moved] == [8, 0, 4]
    assert all(m.regs is strips[(d - 1) % 3].regs
               for d, m in enumerate(moved))


def _strip_meta_args():
    regs = torch.zeros((256, 256), dtype=torch.uint8, device="meta")
    cols = torch.zeros((192, 256), dtype=torch.uint8, device="meta")
    two = torch.zeros(2, dtype=torch.int32, device="meta")
    one = torch.zeros(1, dtype=torch.int32, device="meta")
    return dict(regs_rows=regs, regs_cols=cols,
                tiles=screen.LaunchTiles(two, two, one, one.clone(), two,
                                         two),
                e_rows=torch.zeros(256, device="meta"),
                e_cols=torch.zeros(192, device="meta"),
                fp_rows=torch.zeros((256, 1), dtype=torch.int32,
                                    device="meta"),
                fp_cols=torch.zeros((192, 1), dtype=torch.int32,
                                    device="meta"),
                row_base=256, col_base=0, n_real=400, tau_scr=0.1,
                tau_cb=0.1, p=8, values=(0, 1, 3), ti=64, n_bands=1,
                use_cb=True, use_smh=False)


@pytest.mark.parametrize("change,match", [
    (dict(regs_cols=torch.zeros((192, 256), dtype=torch.int32,
                                device="meta")), "regs_cols must be"),
    (dict(regs_cols=torch.zeros((160, 256), dtype=torch.uint8,
                                device="meta")), "regs_cols must be a"),
    (dict(regs_rows=torch.zeros((256, 128), dtype=torch.uint8,
                                device="meta")), "regs_rows must be"),
    (dict(e_cols=torch.zeros(256, device="meta")), "e_cols must be"),
    (dict(e_rows=torch.zeros(192, device="meta")), "e_rows must be"),
    (dict(fp_cols=torch.zeros((192, 2), dtype=torch.int32, device="meta")),
     "fp_cols must be"),
    (dict(fp_rows=torch.zeros((256, 1), dtype=torch.int64, device="meta")),
     "fp_rows must be"),
    (dict(), "unsupported device"),
])
def test_strip_wrapper_checks_arguments_before_the_device(change, match):
    """Every check of screen_hits_fused_strips, each side against its own
    bank, runs before the device check (so it is reached here with meta
    tensors); inputs that pass them all stop at the device."""
    kw = _strip_meta_args()
    kw.update(change)
    with pytest.raises(ValueError, match=match):
        screen.screen_hits_fused_strips(**kw)
