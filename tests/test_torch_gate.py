"""The gate prune's counts (ops/screen.gate_counts) on CPU tensors, bit-equal
to the JAX package's _gate_counts (parallel/screened.py) and
_ring_gate_counts (parallel/ring.py): every gate combination, 1 to 32
bands, n_real inside a tile, empty columns, CB ties, strips before, level
with and after each other with the triangle's edge inside a tile. Also
the wrapper's argument checks and launch count, and a numpy model of the
CUDA kernel's blocking (csrc/gate_counts.cu: 128-row CTAs, 256-column
shared-memory stages, the block's column range, the per-tile sum of block
partials) held to the plain version on ragged tiles.

The kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py, on the same cases (tests/gate_cases.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gate_cases as gc

from cuda_selection_criteria_tpu.parallel import ring as jring
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu_torch.ops import screen
from cuda_selection_criteria_tpu_torch.parallel import ring, screened

ARRAYS = ("e_rows", "e_cols", "fp_rows", "fp_cols", "row_tiles",
          "col_tiles")


def port_counts(case, use_cb, use_smh, fn=screen.gate_counts):
    t = {k: torch.from_numpy(case[k]) for k in ARRAYS}
    return fn(t["e_rows"], t["e_cols"], t["fp_rows"], t["fp_cols"],
              t["row_tiles"], t["col_tiles"], case["row_base"],
              case["col_base"], case["n_real"], case["tau_cb"],
              case["n_bands"], case["ti"], use_cb, use_smh).numpy()


def jax_bank_counts(case, use_cb, use_smh):
    return np.asarray(jscreened._gate_counts(
        jnp.asarray(case["e_rows"]), jnp.asarray(case["fp_rows"]),
        jnp.asarray(case["row_tiles"]), jnp.asarray(case["col_tiles"]),
        jnp.int32(case["n_real"]), case["tau_cb"], case["n_bands"],
        case["ti"], use_cb, use_smh))


def jax_strip_counts(case, use_cb, use_smh):
    j = {k: jnp.asarray(case[k]) for k in ARRAYS}
    return np.asarray(jring._ring_gate_counts(
        j["e_rows"], j["e_cols"], j["fp_rows"], j["fp_cols"],
        jnp.int32(case["row_base"]), jnp.int32(case["col_base"]),
        j["row_tiles"], j["col_tiles"], jnp.int32(case["n_real"]),
        jnp.float32(case["tau_cb"]), case["n_bands"], case["ti"], use_cb,
        use_smh))


@pytest.mark.parametrize("use_cb,use_smh", gc.GATES)
@pytest.mark.parametrize("n_bands", gc.BANDS)
def test_bank_counts_match_jax(n_bands, use_cb, use_smh):
    case = gc.bank_case(40 + n_bands, n_bands)
    got = port_counts(case, use_cb, use_smh)
    np.testing.assert_array_equal(got, jax_bank_counts(case, use_cb,
                                                       use_smh))
    # the single-bank route of the engine: the strip form with bases 0
    np.testing.assert_array_equal(
        got, port_counts(case, use_cb, use_smh,
                         fn=lambda *a: screened._strip_gate_counts(
                             *a[:4], a[6], a[7], a[4], a[5], *a[8:])))
    assert got.dtype == np.int32
    # tiles below the diagonal count nothing; some above it count pairs
    below = case["row_tiles"] > case["col_tiles"]
    assert not got[below].any() and got[~below].any()


@pytest.mark.parametrize("use_cb,use_smh", gc.GATES)
@pytest.mark.parametrize("where", list(gc.STRIP_BASES))
def test_strip_counts_match_jax(where, use_cb, use_smh):
    case = gc.strip_case(60 + len(where), gc.STRIP_BASES[where])
    got = port_counts(case, use_cb, use_smh)
    np.testing.assert_array_equal(got, jax_strip_counts(case, use_cb,
                                                        use_smh))
    np.testing.assert_array_equal(
        got, port_counts(case, use_cb, use_smh,
                         fn=lambda *a: ring._ring_gate_counts(
                             *a[:4], a[6], a[7], a[4], a[5], *a[8:])))
    if where == "above":  # every column before every row: no i < j pair
        assert not got.any()
    else:
        assert got.any()


@pytest.mark.parametrize("kind", ["bank", "strips"])
def test_cb_ties_pass(kind):
    """A pair with e_a == f32(tau_cb) * e_b passes CB in both packages:
    nudging each tie one ulp down loses pairs, and both counts stay equal
    to the reference's."""
    if kind == "bank":
        case, ref = gc.bank_case(7, 4), jax_bank_counts
    else:
        case, ref = gc.strip_case(8, gc.STRIP_BASES["below"], 4), \
            jax_strip_counts
    tied = port_counts(case, True, False)
    np.testing.assert_array_equal(tied, ref(case, True, False))
    e_r = case["e_rows"].copy()
    ties = np.isin(e_r, gc.TAU_CB * case["e_cols"]) & (e_r > 0)
    assert ties.sum() >= 5
    e_r[ties] = np.nextafter(e_r[ties], np.float32(0))
    nudged = dict(case, e_rows=e_r,
                  e_cols=e_r if kind == "bank" else case["e_cols"])
    got = port_counts(nudged, True, False)
    np.testing.assert_array_equal(got, ref(nudged, True, False))
    assert got.sum() < tied.sum()


def test_cpu_route_launches_nothing():
    before = screen.gate_counts.launches
    port_counts(gc.bank_case(3, 8), True, True)
    assert screen.gate_counts.launches == before == 0


def _good_args():
    case = gc.bank_case(5, 4, ti=16, n_tiles=2)
    t = {k: torch.from_numpy(case[k]) for k in ARRAYS}
    return dict(t, row_base=0, col_base=0, n_real=case["n_real"],
                tau_cb=case["tau_cb"], n_bands=4, ti=16, use_cb=True,
                use_smh=True)


def _call(kw):
    return screen.gate_counts(
        kw["e_rows"], kw["e_cols"], kw["fp_rows"], kw["fp_cols"],
        kw["row_tiles"], kw["col_tiles"], kw["row_base"], kw["col_base"],
        kw["n_real"], kw["tau_cb"], kw["n_bands"], kw["ti"], kw["use_cb"],
        kw["use_smh"])


BAD = {
    "e float64": lambda kw: kw.update(e_cols=kw["e_cols"].double()),
    "fp int64": lambda kw: kw.update(fp_rows=kw["fp_rows"].long()),
    "tiles int64": lambda kw: kw.update(col_tiles=kw["col_tiles"].long()),
    "fp bands": lambda kw: kw.update(n_bands=3),
    "fp rows": lambda kw: kw.update(fp_cols=kw["fp_cols"][:-1]),
    "tiles length": lambda kw: kw.update(col_tiles=kw["col_tiles"][:-1]),
    "e strided": lambda kw: kw.update(
        e_rows=torch.stack([kw["e_rows"]] * 2, 1)[:, 0]),
    "fp strided": lambda kw: kw.update(
        fp_cols=kw["fp_cols"].t().contiguous().t()),
    "tiles strided": lambda kw: kw.update(
        row_tiles=torch.stack([kw["row_tiles"]] * 2, 1)[:, 0]),
    "e on meta": lambda kw: kw.update(e_cols=kw["e_cols"].to("meta")),
    "tiles on meta": lambda kw: kw.update(
        row_tiles=kw["row_tiles"].to("meta")),
    "all on meta": lambda kw: kw.update(
        {k: kw[k].to("meta") for k in ARRAYS}),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_wrapper_rejects(bad):
    kw = _good_args()
    _call(kw)  # the good arguments pass
    BAD[bad](kw)
    with pytest.raises(ValueError, match="gate_counts"):
        _call(kw)
    assert screen.gate_counts.launches == 0


K_ROWS, K_COLS = 128, 256  # csrc/gate_counts.cu: kRows, kCols


def kernel_model(case, use_cb, use_smh):
    """numpy model of csrc/gate_counts.cu: one CTA of K_ROWS rows a (tile,
    row block) with its column range [lo, hi) fixed first (the early
    return), K_COLS columns staged at a time as (threshold, fingerprints),
    a row's diagonal th, and the block's count added to its tile.
    Returns (counts, CTAs that ran past the early return)."""
    e_r, e_c = case["e_rows"], case["e_cols"]
    fp_r, fp_c = case["fp_rows"], case["fp_cols"]
    ti, n_real = case["ti"], case["n_real"]
    row_base, col_base = case["row_base"], case["col_base"]
    tau = np.float32(case["tau_cb"])
    n_rows, n_cols = len(e_r), len(e_c)
    counts = np.zeros(len(case["row_tiles"]), np.int32)
    ran = 0
    lane = np.arange(K_ROWS)
    for t, (rt, ct) in enumerate(zip(case["row_tiles"], case["col_tiles"])):
        cl0 = int(ct) * ti
        gc0 = col_base + cl0
        for r0 in range(0, ti, K_ROWS):
            rl0 = int(rt) * ti + r0
            lo = min(max(row_base + rl0 - gc0 + 1, 0), ti)
            hi = min(max(min(n_real - gc0, n_cols - cl0), 0), ti)
            rows_here = min(max(n_rows - rl0, 0), K_ROWS, ti - r0)
            if lo >= hi or rows_here == 0:
                continue
            ran += 1
            live = lane < rows_here
            rl = np.where(live, rl0 + lane, 0)
            th = np.where(live, np.clip(row_base + rl - gc0, -1, ti), ti)
            er = np.where(live & use_cb, e_r[rl], np.float32(0))
            fr = fp_r[rl]
            cnt = np.zeros(K_ROWS, np.int64)
            for c0 in range(lo, hi, K_COLS):
                nc = min(K_COLS, hi - c0)
                c = e_c[cl0 + c0:cl0 + c0 + nc]
                thr = np.where(c > 0, tau * c if use_cb else np.float32(
                    -np.inf), np.float32(np.nan)).astype(np.float32)
                k = c0 + np.arange(nc)
                g = (k[None, :] > th[:, None]) & (er[:, None] >= thr[None])
                if use_smh:
                    fc = fp_c[cl0 + c0:cl0 + c0 + nc]
                    g &= (fr[:, None, :] == fc[None, :, :]).any(-1)
                cnt += g.sum(1)
            counts[t] += cnt.sum()
    return counts, ran


@pytest.mark.parametrize("use_cb,use_smh", gc.GATES)
@pytest.mark.parametrize("bases", [(0, 0), (140, 100), (0, 300)])
@pytest.mark.parametrize("ti", [130, 300])
def test_kernel_model_matches_plain(ti, bases, use_cb, use_smh):
    case = gc.ragged_case(ti + bases[0], ti, bases=bases)
    got, ran = kernel_model(case, use_cb, use_smh)
    np.testing.assert_array_equal(got, port_counts(case, use_cb, use_smh))
    blocks = len(case["row_tiles"]) * -(-ti // K_ROWS)
    if bases == (0, 0):  # below-diagonal blocks return at once
        assert 0 < ran < blocks
    assert got.any()


@pytest.mark.parametrize("use_cb,use_smh", gc.GATES[:3])
def test_kernel_model_masks_strip_edges(use_cb, use_smh):
    """Tiles that run past the strips' ends: the model, reading only the
    strips' rows, counts what the plain version counts on strips padded
    with rows and columns that pass no gate."""
    case = gc.ragged_case(11, 300, bases=(40, 0))
    cut, padded = gc.cut_strips(case, 700, 830)
    got, _ = kernel_model(cut, use_cb, use_smh)
    want = port_counts(padded, use_cb, use_smh)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not np.array_equal(
        want, port_counts(case, use_cb, use_smh))
