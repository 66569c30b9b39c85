"""The plan's present-value scan (ops/screen.bank_values) and K1's
slot-addressed plane scratch (ops/screen.block_slots / launch_tiles), held
on the CPU against the JAX package.

bank_values: the plain version (a chunked bincount, which numpy arrays and
CPU tensors run) equals the JAX bank_values on HLL banks, aux banks,
uniform bytes, one value and prefixes of a zero-padded copy; a numpy model
of the presence kernel's split (csrc/value_presence.cu: an unaligned head,
16-byte vectors four a thread in a grid-stride loop, a ragged tail, the
register mask of values below 64, the shared path of values from 64 on,
the warp and block ORs) gives the plain version's values through the
wrapper's mask_values; the screened plan's and the ring's values equal the
JAX engines'.

K1's scratch: a numpy model of the launch's block lists and of the pack
into slots reproduces every tile's planes for scattered, repeated, diagonal
and strip tiles; both K1 entries on such tile sets still equal the JAX
kernel (interpret mode), through their plain versions, which read the tile
ids only; the wrappers' checks of the block lists run before the device
check, so meta tensors reach them.

The kernels themselves, K1's block lists and slots among them, are held
against their plain versions on the card in
tests/test_torch_kernels_cuda.py (and by chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_banks import jax_bank, jax_bank_hll, port_bank

from cuda_selection_criteria_tpu.ops import screen as jscreen
from cuda_selection_criteria_tpu.parallel import ring as jring
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu_torch.ops import screen
from cuda_selection_criteria_tpu_torch.parallel import ring, screened
from cuda_selection_criteria_tpu_torch.parallel.mesh import row_mesh
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)
from cuda_selection_criteria_tpu_torch.utils import synth


# ---------------------------------------------------------------- values

def _hll(p, n=24, seed=3):
    rng = np.random.default_rng(seed + p)
    items = np.exp(rng.uniform(np.log(64), np.log(60000), n)).astype(
        np.int64)
    return synth.synthetic_hll_banks(n, items, (p,), rng)[0]


def _padded_sorted(seed=9):
    """A p=10 bank with no zero register, sorted by row sum and padded
    with 40 zero rows: its real rows are the prefix [:24]."""
    regs = _hll(10, seed=seed)
    regs = np.maximum(regs, 1)[np.argsort(regs.sum(1), kind="stable")]
    return np.concatenate([regs, np.zeros((40, regs.shape[1]), np.uint8)])


BANKS = {
    "hll p=8": lambda: _hll(8),
    "hll p=10": lambda: _hll(10),
    "hll p=14": lambda: _hll(14, n=8),
    "aux p_aux=6": lambda: _hll(6, n=64),
    "aux p_aux=8": lambda: _hll(8, n=64, seed=11),
    "uniform 0-255": lambda: np.random.default_rng(5).integers(
        0, 256, size=(37, 300), dtype=np.uint8),
    "one value": lambda: np.full((5, 64), 7, np.uint8),
    "one value 255": lambda: np.full((3, 33), 255, np.uint8),
}


@pytest.mark.parametrize("name", list(BANKS))
def test_plain_bank_values_matches_jax(name):
    """numpy arrays and CPU tensors, whole and chunked, 1-D and 2-D."""
    regs = BANKS[name]()
    want = jscreen.bank_values(regs)
    assert len(want) >= 1
    assert screen.bank_values(regs) == want
    t = torch.from_numpy(regs)
    assert screen.bank_values(t) == want
    assert screen.bank_values(t, chunk=1000) == want
    assert screen.bank_values(t.reshape(-1)[7:], chunk=777) == \
        jscreen.bank_values(regs.reshape(-1)[7:])
    if name == "uniform 0-255":
        assert want == tuple(range(256))


@pytest.mark.parametrize("n", [0, 1, 17, 24])
def test_plain_bank_values_on_prefixes_of_a_padded_copy(n):
    """The callers pass the real rows [:n] of the padded sorted bank: the
    padding's zero rows never add the value 0."""
    padded = _padded_sorted()
    want = jscreen.bank_values(padded[:n]) if n else ()
    assert screen.bank_values(padded[:n]) == want
    assert screen.bank_values(torch.from_numpy(padded)[:n],
                              chunk=4096) == want
    assert 0 not in want
    assert screen.bank_values(padded)[0] == 0


def test_mask_values_reads_bit_b_of_word_w_as_32w_plus_b():
    for vals in ((), (0,), (31, 32), (63, 64), (0, 100, 200, 255),
                 tuple(range(256))):
        words = np.zeros(8, np.uint32)
        for v in vals:
            words[v >> 5] |= np.uint32(1 << (v & 31))
        assert screen.mask_values(words) == vals
        assert screen.mask_values(words.view(np.int32)) == vals


def _kernel_mask(x, addr, threads=256, blocks=1):
    """numpy model of csrc/value_presence.cu on the bytes x at an address
    that is addr modulo 16: the 8 mask words. Every thread keeps a 64-bit
    register mask of the values below 64 and sets the others in its block's
    shared words; vectors past the end repeat vector i."""
    n = len(x)
    head = min((16 - addr % 16) % 16, n)
    nvec = (n - head) // 16
    tail0 = head + nvec * 16
    stride = threads * blocks
    mask = [0] * 8
    for b in range(blocks):
        shared = [0] * 8

        def add_byte(v, lo):
            if v < 64:
                return lo | (1 << v)
            shared[v >> 5] |= 1 << (v & 31)
            return lo

        lanes = []
        for tid in range(threads):
            gid = b * threads + tid
            lo = 0
            for i in range(gid, nvec, 4 * stride):
                for u in range(4):
                    j = i + u * stride
                    vec = x[head + 16 * (j if j < nvec else i):][:16]
                    for w in vec.view("<u4").tolist():
                        if w & 0xC0C0C0C0 == 0:
                            for k in range(4):
                                lo |= 1 << ((w >> (8 * k)) & 0xFF)
                        else:
                            for k in range(4):
                                lo = add_byte((w >> (8 * k)) & 0xFF, lo)
            if gid < head + (n - tail0):
                lo = add_byte(int(x[gid if gid < head
                                    else tail0 + gid - head]), lo)
            lanes.append(lo)
        for w0 in range(0, threads, 32):
            warp = 0
            for lo in lanes[w0:w0 + 32]:
                warp |= lo
            shared[0] |= warp & 0xFFFFFFFF
            shared[1] |= warp >> 32
        for k in range(8):
            mask[k] |= shared[k]
    return np.array(mask, np.uint32)


def _model_bytes(kind, n, rng):
    if kind == "below 64":
        return rng.integers(0, 64, n, dtype=np.uint8)
    if kind == "uniform":
        return rng.integers(0, 256, n, dtype=np.uint8)
    x = rng.integers(1, 60, n, dtype=np.uint8)
    if n:  # one special value, at the first, last or a middle byte
        pos = {"0 first": 0, "63 last": n - 1, "64 middle": n // 2,
               "255 last": n - 1, "255 first": 0}[kind]
        x[pos] = int(kind.split()[0])
    return x


MODEL_KINDS = ("below 64", "uniform", "0 first", "63 last", "64 middle",
               "255 last", "255 first")


@pytest.mark.parametrize("rem", range(16))
def test_kernel_model_matches_plain(rem):
    """Lengths 16k + rem, the bytes at every alignment class that moves the
    head; each byte kind: values below 64 only, uniform bytes, and 0, 63,
    64 or 255 once at the first, a middle or the last byte."""
    rng = np.random.default_rng(100 + rem)
    for k in (0, 1, 6):
        n = 16 * k + rem
        for kind in MODEL_KINDS:
            x = _model_bytes(kind, n, rng)
            want = screen._bank_values_plain(torch.from_numpy(x), 1 << 24)
            for addr in (0, 3, 15):
                got = screen.mask_values(_kernel_mask(x, addr))
                assert got == want, (n, kind, addr)


@pytest.mark.parametrize("threads,blocks", [(32, 1), (32, 3), (64, 2)])
def test_kernel_model_grid_stride_matches_plain(threads, blocks):
    """Several blocks and a grid-stride loop that wraps, with the repeat of
    vector i past the end: the mask is the plain version's."""
    rng = np.random.default_rng(threads + blocks)
    for n in (16 * 40 + 5, 16 * 97, 16 * 300 + 11):
        for kind in ("below 64", "uniform", "255 last"):
            x = _model_bytes(kind, n, rng)
            want = screen._bank_values_plain(torch.from_numpy(x), 1 << 24)
            assert screen.mask_values(
                _kernel_mask(x, 7, threads, blocks)) == want


def _plans(crit, seed):
    if crit == "hll_a":
        jb = jax_bank_hll(48, 10, 6, seed)
    else:
        jb = jax_bank(48, 10, 16, seed)
    return jb, port_bank(jb)


@pytest.mark.parametrize("crit,tau", [("smh_a", 0.15), ("hll_a", 0.1)])
def test_plan_values_match_jax(crit, tau):
    """ScreenPlan.values and values_aux (the scan of the device copy's real
    rows) equal the JAX plan's."""
    jb, bank = _plans(crit, 23)
    jp = jscreened.ScreenPlan(jb, JParams(tau=tau, criterion=crit), 16)
    pp = screened.ScreenPlan(bank, SelectionParams(tau=tau, criterion=crit),
                             16, device="cpu")
    assert pp.values == jp.values and len(pp.values) >= 2
    assert pp.values_aux == jp.values_aux
    assert (pp.values_aux is not None) == (crit == "hll_a")


class _Captured(Exception):
    pass


@pytest.mark.parametrize("crit,tau", [("smh_a", 0.15), ("hll_a", 0.1)])
def test_ring_values_match_jax(crit, tau, monkeypatch):
    """The ring's values and aux spec (the union of the strips' real rows'
    scans) equal the JAX ring's (the scan of the whole bank), on 3 and 8
    strips; each engine stops where it builds its ring primitives."""
    jb, bank = _plans(crit, 29)
    seen = {}

    def capture(key, pos):
        def fn(*args, **kw):
            seen[key] = (args[pos], kw.get("aux"))
            raise _Captured
        return fn

    monkeypatch.setattr(jring, "make_ring_fns", capture("jax", 2))
    monkeypatch.setattr(ring, "make_ring_fns", capture("port", 2))
    with pytest.raises(_Captured):
        jring.select_pairs_ring(jb, JParams(tau=tau, criterion=crit), ti=8)
    for n_dev in (3, 8):
        with pytest.raises(_Captured):
            ring.select_pairs_ring(bank, SelectionParams(
                tau=tau, criterion=crit), mesh=row_mesh(["cpu"] * n_dev),
                ti=8)
        assert seen["port"] == seen["jax"]
    assert len(seen["jax"][0]) >= 2
    assert (seen["jax"][1] is not None) == (crit == "hll_a")


def test_bank_values_checks_before_the_device():
    """Type, contiguity and device are checked on any tensor; meta tensors
    reach the device check."""
    meta = torch.zeros((64, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        screen.bank_values(meta)
    with pytest.raises(ValueError, match="contiguous"):
        screen.bank_values(meta.t())
    with pytest.raises(ValueError, match="uint8"):
        screen.bank_values(meta.to(torch.int32))


# ------------------------------------------------- K1's slot-addressed pack

P, TI = 8, 64


def _planes(regs, thr):
    """bool (rows, nbins, 2^p) bit-planes: [reg <= thr_k], the pack
    stage's planes before the 32-bit packing."""
    return regs[:, None, :] <= np.asarray(thr, np.uint8)[None, :, None]


# (label, row tiles, col tiles, row bank blocks, col bank blocks or None
# for one bank on both sides, shared)
SLOT_CASES = [
    ("scattered", [0, 7, 3, 9], [9, 7, 5, 9], 10, None, True),
    ("repeated", [2, 2, 2, 5, 5], [5, 5, 2, 2, 5], 10, None, True),
    ("diagonal", [0, 1, 4, 9], [0, 1, 4, 9], 10, None, True),
    ("first and last", [0, 9, 0], [9, 9, 0], 10, None, True),
    ("one bank, two lists", [1, 3, 3], [3, 8, 1], 10, None, False),
    ("strips", [0, 2, 2, 1], [4, 0, 4, 3], 3, 5, False),
    ("strips, one tile", [2], [4], 3, 5, False),
]


@pytest.mark.parametrize("case", SLOT_CASES, ids=[c[0] for c in SLOT_CASES])
def test_block_slots_and_pack_model(case):
    """block_slots lists each side's distinct blocks, ascending, with every
    tile's slot; a pack of those blocks into slots gives every tile's rows'
    planes at its slots; the scratch holds blocks * ti rows, each block
    once. launch_tiles puts the same on the device in one tensor."""
    label, rows, cols, nb_r, nb_c, shared = case
    rng = np.random.default_rng(len(label))
    regs_r = rng.integers(0, 12, size=(nb_r * TI, 1 << P), dtype=np.uint8)
    regs_c = (regs_r if nb_c is None else
              rng.integers(0, 12, size=(nb_c * TI, 1 << P), dtype=np.uint8))
    thr = (0, 3, 7, 10)
    rb, cb, rs, cs = screen.block_slots(np.array(rows, np.int32),
                                        np.array(cols, np.int32), shared)
    for blocks, slot, tiles in ((rb, rs, rows), (cb, cs, cols)):
        assert blocks.dtype == slot.dtype == np.int32
        assert (np.diff(blocks) > 0).all()
        np.testing.assert_array_equal(blocks[slot], tiles)
    if shared:
        assert rb is cb
        np.testing.assert_array_equal(rb, np.unique(rows + cols))
    else:
        np.testing.assert_array_equal(rb, np.unique(rows))
        np.testing.assert_array_equal(cb, np.unique(cols))

    def pack(regs, blocks):  # the pack stage: block blocks[s] into slot s
        src = (blocks[:, None] * TI + np.arange(TI)[None, :]).reshape(-1)
        return _planes(regs[src], thr)

    scratch_r = pack(regs_r, rb)
    scratch_c = scratch_r if (shared and regs_c is regs_r) else pack(regs_c,
                                                                     cb)
    assert scratch_r.shape[0] == len(rb) * TI <= regs_r.shape[0]
    for t, (r, c) in enumerate(zip(rows, cols)):
        np.testing.assert_array_equal(
            scratch_r[rs[t] * TI:(rs[t] + 1) * TI],
            _planes(regs_r[r * TI:(r + 1) * TI], thr))
        np.testing.assert_array_equal(
            scratch_c[cs[t] * TI:(cs[t] + 1) * TI],
            _planes(regs_c[c * TI:(c + 1) * TI], thr))

    lt = screen.launch_tiles(rows, cols, shared, "cpu")
    for got, want in zip(lt, (rows, cols, rb, cb, rs, cs)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    assert (lt.col_blocks is lt.row_blocks) == shared
    assert lt.row_tiles.untyped_storage().data_ptr() == \
        lt.row_slot.untyped_storage().data_ptr()  # one copy


def _k1_inputs(seed, n):
    rng = np.random.default_rng(seed)
    regs = rng.integers(0, 11, size=(n, 1 << P), dtype=np.uint8)
    e = np.sort(rng.uniform(0, 5000, n) * 20.0).astype(np.float32)
    e[:3] = 0.0
    aux = rng.integers(0, 1 << 63, size=(n, 16), dtype=np.uint64)
    aux[1::7] = aux[0]
    return regs, e, jscreened.band_fingerprints_np(aux, 4, 4)


K1_TILES = {
    "scattered": ([0, 1, 2], [2, 1, 2]),
    "repeated": ([1, 1, 1, 0], [1, 2, 1, 1]),
    "diagonal": ([0, 1, 2], [0, 1, 2]),
}


@pytest.mark.parametrize("label", list(K1_TILES))
def test_k1_entries_on_block_tile_sets_match_jax(label):
    """screen_hits_fused and the strip entry (one bank on both sides, bases
    0) on tile sets that scatter, repeat and sit on the diagonal equal the
    JAX kernel in interpret mode, hits and counts. On CPU tensors both run
    their plain versions, which read the tile ids only: the block lists
    and slots are held here by test_block_slots_and_pack_model, and on the
    card by tests/test_torch_kernels_cuda.py."""
    ti, n = 128, 384
    regs, e, fp = _k1_inputs(7 + len(label), n)
    rows, cols = (np.array(x, np.int32) for x in K1_TILES[label])
    vals = screen.bank_values(regs)
    kw = dict(n_real=n - 5, tau_scr=0.4, tau_cb=0.35, p=P, values=vals,
              ti=ti, n_bands=4, use_cb=True, use_smh=True)
    jh, jc = jscreen.screen_hits_fused(
        jnp.asarray(regs), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(e), jnp.asarray(fp), jnp.int32(kw["n_real"]),
        jnp.float32(0.4), jnp.float32(0.35), P, vals, ti, 4, True, True,
        interpret=True)
    t = [torch.from_numpy(x) for x in (regs, e, fp)]
    h, c = screen.screen_hits_fused(
        t[0], screen.launch_tiles(rows, cols, True, "cpu"), t[1], t[2], **kw)
    hs, cs = screen.screen_hits_fused_strips(
        t[0], t[0], screen.launch_tiles(rows, cols, False, "cpu"), t[1],
        t[1], t[2], t[2], 0, 0, **kw)
    for hits, counts in ((h, c), (hs, cs)):
        np.testing.assert_array_equal(hits.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert int(c.sum()) > 0


def _meta_tiles(n_tiles=2, n_blocks=2, dtype=torch.int32):
    z = dict(dtype=torch.int32, device="meta")
    b = torch.zeros(n_blocks, dtype=dtype, device="meta")
    return screen.LaunchTiles(torch.zeros(n_tiles, **z),
                              torch.zeros(n_tiles, **z), b, b,
                              torch.zeros(n_tiles, **z),
                              torch.zeros(n_tiles, **z))


def _meta_k1(strips):
    regs = torch.zeros((256, 256), dtype=torch.uint8, device="meta")
    e = torch.zeros(256, device="meta")
    fp = torch.zeros((256, 1), dtype=torch.int32, device="meta")
    kw = dict(n_real=250, tau_scr=0.1, tau_cb=0.1, p=8, values=(0, 1, 3),
              ti=64, n_bands=1, use_cb=True, use_smh=False)
    if strips:
        cols = torch.zeros((128, 256), dtype=torch.uint8, device="meta")
        return (screen.screen_hits_fused_strips,
                dict(regs_rows=regs, regs_cols=cols, e_rows=e,
                     e_cols=e[:128], fp_rows=fp, fp_cols=fp[:128],
                     row_base=0, col_base=256, **kw))
    return screen.screen_hits_fused, dict(regs=regs, e=e, fp=fp, **kw)


def _apart(tiles, n_col_blocks=1):
    """tiles with a column list of its own (n_col_blocks long)."""
    return tiles._replace(col_blocks=torch.zeros(
        n_col_blocks, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("strips,tiles,match", [
    (False, _meta_tiles(dtype=torch.int64), "tiles.row_blocks"),
    (False, _meta_tiles(n_blocks=5), "tiles.row_blocks"),
    (False, _meta_tiles(n_blocks=0), "tiles.row_blocks"),
    (False, _meta_tiles()._replace(
        row_slot=torch.zeros(3, dtype=torch.int32, device="meta")),
     "tiles.row_slot"),
    (False, _meta_tiles()._replace(
        col_slot=torch.zeros(2, dtype=torch.int64, device="meta")),
     "tiles.col_slot"),
    (False, _meta_tiles(), "unsupported device"),
    (True, _meta_tiles(), "shared block list"),
    (True, _apart(_meta_tiles(), 3), "tiles.col_blocks"),
    (True, _apart(_meta_tiles(), 2), "unsupported device"),
])
def test_k1_block_checks_run_before_the_device(strips, tiles, match):
    """Every check of a LaunchTiles' block lists runs before the device
    check: lists of 1..rows/ti int32 blocks a side, (T,) int32 slots, and
    one shared list only for one bank on both sides."""
    fn, kw = _meta_k1(strips)
    with pytest.raises(ValueError, match=match):
        fn(tiles=tiles, **kw)
