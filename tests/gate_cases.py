"""Inputs of the gate-count tests, made with numpy from a seed: the CPU
tests (tests/test_torch_gate.py) hand them to the JAX package and the
port, the card tests (tests/test_torch_kernels_cuda.py) to the kernel and
its plain version. Imports neither JAX nor torch."""

import numpy as np

TAU_CB = np.float32(0.8)
BANDS = (1, 4, 8, 16, 32)
GATES = [(True, True), (True, False), (False, True), (False, False)]
# (row_base, col_base) of a 240-row row strip and a 288-row column strip at
# ti = 48: the column strip after, level with and before the row strip,
# and the triangle's edge inside a tile (a base difference of 20)
STRIP_BASES = {"below": (0, 240), "level": (96, 96), "above": (336, 48),
               "edge in tile": (116, 96)}


def side(rng, n, n_bands, lo=1000.0, hi=2000.0):
    """(e, fp) of one side: sorted f32 cardinalities, some zero (empty
    columns), and int32 band fingerprints drawn from 4 * n_bands values,
    so about a fifth of the pairs share a band."""
    e = np.sort(rng.uniform(lo, hi, n)).astype(np.float32)
    e[:3] = 0.0
    e[7::13] = 0.0
    fp = rng.integers(0, 4 * n_bands, size=(n, n_bands)).astype(np.int32)
    return e, fp


def plant_ties(e_rows, e_cols, rows, cols, tau_cb=TAU_CB):
    """CB ties: e_rows[i] = f32(tau_cb) * e_cols[j] exactly, in place, for
    each (i, j) of rows x cols whose column is not empty."""
    for i, j in zip(rows, cols):
        if e_cols[j] > 0:
            e_rows[i] = np.float32(tau_cb) * e_cols[j]


def bank_case(seed, n_bands, ti=48, n_tiles=5):
    """One bank (both sides the same, bases 0) of n_tiles * ti rows with
    n_real inside the last tile, CB ties planted, and every (row tile,
    column tile) pair in the list, the ones below the diagonal too."""
    rng = np.random.default_rng(seed)
    n = n_tiles * ti
    e, fp = side(rng, n, n_bands)
    i = np.arange(5, n // 2, 11)
    plant_ties(e, e, i, i + n // 2 - 3)
    r, c = np.meshgrid(np.arange(n_tiles), np.arange(n_tiles), indexing="ij")
    return dict(e_rows=e, e_cols=e, fp_rows=fp, fp_cols=fp,
                row_tiles=r.ravel().astype(np.int32),
                col_tiles=c.ravel().astype(np.int32), row_base=0,
                col_base=0, n_real=n - 17, tau_cb=TAU_CB, n_bands=n_bands,
                ti=ti)


def strip_case(seed, bases, n_bands=8, ti=48, n_r=240, n_c=288):
    """A row strip of n_r rows and a column strip of n_c rows at global
    bases `bases`, n_real inside the column strip's last tile, CB ties
    planted between them, every (row tile, column tile) pair."""
    rng = np.random.default_rng(seed)
    e_r, fp_r = side(rng, n_r, n_bands)
    e_c, fp_c = side(rng, n_c, n_bands, 1100.0, 2100.0)
    i = np.arange(4, n_r, 9)
    plant_ties(e_r, e_c, i, (i * 7 + 5) % n_c)
    r, c = np.meshgrid(np.arange(n_r // ti), np.arange(n_c // ti),
                       indexing="ij")
    row_base, col_base = bases
    return dict(e_rows=e_r, e_cols=e_c, fp_rows=fp_r, fp_cols=fp_c,
                row_tiles=r.ravel().astype(np.int32),
                col_tiles=c.ravel().astype(np.int32), row_base=row_base,
                col_base=col_base, n_real=col_base + n_c - 29,
                tau_cb=TAU_CB, n_bands=n_bands, ti=ti)


def ragged_case(seed, ti, n_bands=8, bases=(0, 0), n_tiles=3):
    """Tiles whose edge is no multiple of the kernel's 128-row CTAs or
    256-column stages: n_tiles * ti rows a side, n_real inside the last
    tile, the triangle's edge inside a tile where the bases differ."""
    rng = np.random.default_rng(seed)
    n = n_tiles * ti
    e_r, fp_r = side(rng, n, n_bands)
    same = bases == (0, 0)
    e_c, fp_c = (e_r, fp_r) if same else side(rng, n, n_bands)
    i = np.arange(2, n, 5)
    plant_ties(e_r, e_c, i, (i * 3 + 1) % n)
    r, c = np.meshgrid(np.arange(n_tiles), np.arange(n_tiles), indexing="ij")
    return dict(e_rows=e_r, e_cols=e_c, fp_rows=fp_r, fp_cols=fp_c,
                row_tiles=r.ravel().astype(np.int32),
                col_tiles=c.ravel().astype(np.int32), row_base=bases[0],
                col_base=bases[1], n_real=bases[1] + n - 37, tau_cb=TAU_CB,
                n_bands=n_bands, ti=ti)


def cut_strips(case, n_rows, n_cols):
    """The case with its row strip cut to n_rows rows and its column strip
    to n_cols (the last tiles then run past the strips' edges), and the
    padded case that counts the same pairs: the cut columns made empty
    (e = 0), the cut rows made to fail CB (e = -1) and every band (fp
    values no column holds). Returns (cut, padded); the padding holds
    only where CB or the bands gate the pairs."""
    cut = dict(case)
    pad = dict(case)
    e_r, e_c = case["e_rows"].copy(), case["e_cols"].copy()
    fp_r, fp_c = case["fp_rows"].copy(), case["fp_cols"].copy()
    cut.update(e_rows=e_r[:n_rows].copy(), e_cols=e_c[:n_cols].copy(),
               fp_rows=fp_r[:n_rows].copy(), fp_cols=fp_c[:n_cols].copy())
    e_r[n_rows:] = -1.0
    fp_r[n_rows:] = -1 - np.arange(fp_r[n_rows:].size, dtype=np.int32
                                   ).reshape(fp_r[n_rows:].shape)
    e_c[n_cols:] = 0.0
    pad.update(e_rows=e_r, e_cols=e_c, fp_rows=fp_r, fp_cols=fp_c)
    return cut, pad
