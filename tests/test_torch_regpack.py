"""The port's packed bank upload (ops/regpack, the native presence scan and
packers, parallel/screened.upload_sorted_rows(pack=), ScreenPlan and
select_pairs_ring with upload_pack=True) against the JAX package's on the
CPU, inputs made from numpy seeds. Every comparison is bit-equality: the
plans, the packed planes, the presence, the decoded rows, the uploaded
banks and the selection lines. The unpack kernel itself runs on the card
(tests/test_torch_kernels_cuda.py); here a numpy model of its thread loop
is held to the plain version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cuda_selection_criteria_tpu.ops import regpack as jregpack
from cuda_selection_criteria_tpu.ops import screen as jscreen
from cuda_selection_criteria_tpu.parallel import ring as jring
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu_torch.native import fastx
from cuda_selection_criteria_tpu_torch.ops import regpack
from cuda_selection_criteria_tpu_torch.parallel import ring, screened
from cuda_selection_criteria_tpu_torch.parallel.mesh import row_mesh
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)
from torch_banks import jax_bank, jax_bank_hll, port_bank

UPLOAD_KEYS = {"slabs", "gather_secs", "put_ret_secs", "token_wait_secs",
               "pack_secs", "pack_bits"}


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """Both routes of both packages: the native library, or (with it
    hidden) the numpy forms."""
    if request.param == "numpy":
        monkeypatch.setattr(regpack.fastx, "available", lambda: False)
        monkeypatch.setattr(jregpack, "_native_pack_broken", True)
    else:
        assert fastx.available(), fastx.info()["error"]
    return request.param


def _alphabet(rng, size, top=255):
    return sorted(int(v) for v in rng.choice(top + 1, size, replace=False))


def _rows(rng, vals, shape):
    return rng.choice(np.array(vals, np.uint8), size=shape)


# alphabets of every k = 1..7: sizes at each width's lower and upper end
PLAN_SIZES = [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128]


@pytest.mark.parametrize("size", PLAN_SIZES)
def test_plan_pack_matches_jax(size):
    rng = np.random.default_rng(size)
    for vals in (_alphabet(rng, size), list(range(size)),
                 list(range(256 - size, 256))):
        got, want = regpack.plan_pack(vals), jregpack.plan_pack(vals)
        assert got is not None and want is not None
        assert got[2] == want[2] == max(1, int(np.ceil(np.log2(max(size,
                                                                    2)))))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == got[0].dtype == np.uint8
        assert got[1].shape == (1 << got[2],)


@pytest.mark.parametrize("vals", [range(300), range(200), range(129), [256],
                                  []])
def test_plan_pack_refuses_like_jax(vals):
    """More than 255 values, k >= 8 (200 and 129 values), a value above
    255 and an empty alphabet: no plan in either package."""
    assert regpack.plan_pack(vals) is None
    assert jregpack.plan_pack(vals) is None


def _pack_case(r, layout, k_size=13, s=7):
    rng = np.random.default_rng(r * 3 + len(layout))
    vals = _alphabet(rng, k_size, 60)
    if layout == "contiguous":
        rows = _rows(rng, vals, (s, r))
    else:  # every other row of a wider bank: not C-contiguous
        rows = _rows(rng, vals, (2 * s, r))[::2]
        assert not rows.flags.c_contiguous
    return vals, rows


@pytest.mark.parametrize("r", [8, 64, 512, 16384])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_pack_rows_matches_jax(route, r, layout):
    vals, rows = _pack_case(r, layout)
    lut, table, k = regpack.plan_pack(vals)
    got = regpack.pack_rows(rows, lut, k)
    want = jregpack.pack_rows(rows, lut, k)
    assert got.shape == (len(rows), k, r // 8) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the layout itself: plane j = packbits of bit j, little bit order
    idx = lut[rows]
    for j in range(k):
        np.testing.assert_array_equal(
            got[:, j], np.packbits((idx >> j) & 1, axis=1,
                                   bitorder="little"))
    # into a caller's out, through a reused scratch, and on one thread
    out = np.empty_like(got)
    scratch = {}
    for _ in range(2):
        regpack.pack_rows(rows, lut, k, out=out, scratch=scratch, threads=1)
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("r", [8, 64, 512, 16384])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_gather_pack_rows_matches_jax(route, r, layout):
    vals, bank = _pack_case(r, layout, s=11)
    rng = np.random.default_rng(r)
    order = np.concatenate([rng.permutation(len(bank)), [3, 3, 0]])
    lut, table, k = regpack.plan_pack(vals)
    got = regpack.gather_pack_rows(bank, order, lut, k)
    want = jregpack.gather_pack_rows(bank, order, lut, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, regpack.pack_rows(
        np.ascontiguousarray(bank[order]), lut, k))
    out = np.empty_like(got)
    scratch = {}
    for _ in range(2):
        regpack.gather_pack_rows(bank, order.astype(np.int32), lut, k,
                                 out=out, scratch=scratch, threads=3)
        np.testing.assert_array_equal(out, want)


def test_native_packers_refuse_bad_arguments():
    """The native packers' checks: rows of a register count that is not
    a multiple of 8, k outside 1..7 and a row index out of range."""
    rows = np.zeros((2, 12), np.uint8)
    lut = np.zeros(256, np.uint8)
    with pytest.raises(ValueError, match="rc=-1"):
        fastx.pack_bitplanes(rows, lut, 2, np.empty((2, 2, 1), np.uint8))
    rows = np.zeros((2, 16), np.uint8)
    with pytest.raises(ValueError, match="rc=-1"):
        fastx.pack_bitplanes(rows, lut, 8, np.empty((2, 8, 2), np.uint8))
    with pytest.raises(ValueError, match="rc=-3"):
        fastx.gather_pack_bitplanes(rows, [0, 2], lut, 1,
                                    np.empty((2, 1, 2), np.uint8))
    with pytest.raises(ValueError, match="C-contiguous"):
        fastx.pack_bitplanes(rows[:, ::2], lut, 1,
                             np.empty((2, 1, 1), np.uint8))


@pytest.mark.parametrize("case", ["hll", "all256", "one", "strided",
                                  "large"])
def test_host_values_matches_jax_bank_values(route, case):
    rng = np.random.default_rng(len(case))
    if case == "hll":
        regs = _rows(rng, [0, 5, 6, 7, 8, 9, 12, 21], (37, 512))
    elif case == "all256":
        regs = rng.integers(0, 256, (16, 4096), dtype=np.uint8)
    elif case == "one":
        regs = np.full((5, 64), 17, np.uint8)
    elif case == "strided":
        regs = _rows(rng, [1, 2, 40], (40, 64))[::3]
    else:  # past one numpy chunk and one native thread's share
        regs = _rows(rng, [0, 3, 11, 50], (1100, 16384))
    want = jscreen.bank_values(regs)
    assert regpack.host_values(regs) == want
    assert regpack.host_values(regs, chunk=1000) == want
    if regs.flags.c_contiguous and route == "native":
        present = fastx.value_presence(regs, threads=3)
        assert tuple(np.nonzero(present)[0]) == want


@pytest.mark.parametrize("k", range(1, 8))
@pytest.mark.parametrize("r", [8, 64, 136])  # 136: 17 bytes a plane
def test_unpack_plain_matches_jax_unpack_place(k, r):
    rng = np.random.default_rng(10 * k + r)
    vals = ([1, 9, 33, 200, 255] if k == 3  # an alphabet without 0
            else _alphabet(rng, (1 << (k - 1)) + 1 if k > 1 else 2))
    lut, table, kk = regpack.plan_pack(vals)
    assert kk == k
    rows = _rows(rng, vals, (9, r))
    packed = regpack.pack_rows(rows, lut, k)
    for i0 in (0, 3, 7):
        out = torch.zeros((16, r), dtype=torch.uint8)
        got = regpack._unpack_rows_plain(out, torch.from_numpy(packed),
                                         torch.from_numpy(table), i0, k)
        assert got is out
        want, _ = jregpack.unpack_place(
            jnp.zeros((16, r), jnp.uint8), jnp.asarray(packed),
            jnp.asarray(table), jnp.int32(i0), k)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        np.testing.assert_array_equal(out.numpy()[i0:i0 + 9], rows)
        # the wrapper on CPU tensors is the plain version
        out2 = torch.zeros((16, r), dtype=torch.uint8)
        regpack.unpack_rows(out2, torch.from_numpy(packed),
                            torch.from_numpy(table), i0, k)
        assert torch.equal(out2, out)


def _kernel_model(packed, table, k, blocks, threads=256):
    """numpy model of csrc/regpack_unpack.cu: one thread a (row, byte)
    group, the grid-stride loop with the row and byte advanced by the
    stride's quotient and remainder, each plane byte spread to 8 bytes by
    the nibble multiply, the table lookup, one little-endian 8-byte word a
    group."""
    s, _, r8 = packed.shape
    groups = s * r8
    flat = packed.reshape(-1)
    out = np.zeros(groups, np.uint64)
    stride = blocks * threads
    seen = np.zeros(groups, np.int64)

    def spread4(n):
        return (n * 0x00204081) & 0x01010101

    for g0 in range(min(stride, groups)):
        gs, gc = divmod(g0, r8)
        ds, dc = divmod(stride, r8)
        for g in range(g0, groups, stride):
            assert (gs, gc) == divmod(g, r8)
            idx = 0
            for j in range(k):
                b = int(flat[(gs * k + j) * r8 + gc])
                idx |= (spread4(b & 0xF) | spread4(b >> 4) << 32) << j
            w = 0
            for bi in range(8):
                w |= int(table[(idx >> (8 * bi)) & 0x7F]) << (8 * bi)
            out[g] = w
            seen[g] += 1
            gs, gc = gs + ds, gc + dc
            if gc >= r8:
                gc -= r8
                gs += 1
    assert (seen == 1).all()
    return out.view("<u1").reshape(s, 8 * r8)


@pytest.mark.parametrize("k,r,s,blocks", [
    (1, 8, 5, 1), (2, 136, 40, 1), (5, 24, 100, 1), (7, 24, 13, 1),
    (6, 8, 600, 1), (3, 40, 77, 2)])
def test_unpack_kernel_model_matches_plain(k, r, s, blocks):
    """The kernel's arithmetic and its walk over the groups (strides that
    are and are not multiples of R/8, a grid larger than the groups)
    against _unpack_rows_plain."""
    rng = np.random.default_rng(k * r + s)
    vals = sorted(rng.choice(np.arange(1, 200), (1 << k) - (k > 1),
                             replace=False).tolist())
    lut, table, kk = regpack.plan_pack(vals)
    assert kk == k
    rows = _rows(rng, vals, (s, r))
    packed = regpack.pack_rows(rows, lut, k)
    want = regpack._unpack_rows_plain(
        torch.zeros((s, r), dtype=torch.uint8), torch.from_numpy(packed),
        torch.from_numpy(table), 0, k).numpy()
    np.testing.assert_array_equal(want, rows)
    np.testing.assert_array_equal(_kernel_model(packed, table, k, blocks),
                                  want)


def test_unpack_rows_rejects_bad_arguments():
    out = torch.zeros((8, 64), dtype=torch.uint8)
    planes = torch.zeros((4, 3, 8), dtype=torch.uint8)
    table = torch.zeros(8, dtype=torch.uint8)
    for args, msg in [
            ((out.int(), planes, table, 0, 3), "2-D uint8 out"),
            ((out, planes[0], table, 0, 3), "planes expected"),
            ((out, planes, table, 0, 2), "k = 2 with 3 planes"),
            ((out, planes[:, :, :4], table, 0, 3), "rows of 64 registers"),
            ((out, planes, table, 5, 3), "outside an out of 8 rows"),
            ((out, planes, table, -1, 3), "outside"),
            ((out, planes, table[:4], 0, 3), "table of 8 values"),
            ((out, planes, table.to("meta"), 0, 3), "different devices"),
            ((out.to("meta"), planes.to("meta"), table.to("meta"), 0, 3),
             "unsupported device")]:
        with pytest.raises(ValueError, match=msg):
            regpack.unpack_rows(*args)


N, R = 100, 64  # the upload's bank rows and bytes a row


def _bank():
    rng = np.random.default_rng(11)
    vals = [0, 2, 3, 7, 11, 12, 30, 39, 40]
    return _rows(rng, vals, (N, R)), rng.permutation(N), vals


# tests/test_torch_upload.py's cases, and the bank in its own order
@pytest.mark.parametrize("lo,rows_out,slab_rows,ordered", [
    (0, 128, 1 << 20, True),
    (0, 100, 10, True),
    (37, 48, 7, True),
    (64, 64, 9, True),
    (90, 30, 1, True),
    (100, 16, 8, True),
    (130, 4, 8, True),
    (0, 101, 16, False),
    (37, 48, 7, False),
])
def test_packed_upload_matches_jax_and_raw(route, lo, rows_out, slab_rows,
                                           ordered):
    regs, order, vals = _bank()
    plan = regpack.plan_pack(vals)
    jorder = order if ordered else np.arange(N)
    want_stats, got_stats, raw_stats = {}, {}, {}
    want = np.asarray(jscreened.upload_sorted_rows(
        regs, jorder, lo, rows_out, slab_bytes=slab_rows * R,
        stats=want_stats, pack=plan))
    got = screened.upload_sorted_rows(
        regs, order if ordered else None, lo, rows_out, "cpu",
        slab_bytes=slab_rows * R, stats=got_stats, pack=plan)
    raw = screened.upload_sorted_rows(
        regs, order if ordered else None, lo, rows_out, "cpu",
        slab_bytes=slab_rows * R, stats=raw_stats)
    assert got.dtype == torch.uint8 and got.shape == (rows_out, R)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, raw)
    assert set(got_stats) == set(want_stats)
    count = max(0, min(N - lo, rows_out))
    if count:
        assert set(got_stats) == set(raw_stats) == UPLOAD_KEYS
        assert got_stats["pack_bits"] == want_stats["pack_bits"] == 4
        assert raw_stats["pack_bits"] == 0
        assert got_stats["slabs"] == want_stats["slabs"] == \
            -(-count // slab_rows)
        assert got_stats["gather_secs"] == 0.0 < got_stats["pack_secs"]


@pytest.mark.parametrize("threads", [1, 3, 16])
@pytest.mark.parametrize("ordered", [True, False])
def test_packed_upload_threads_give_the_same_rows(route, threads, ordered):
    """The slab's pack shared by host threads (more threads than rows a
    slab included), from a bank that is not C-contiguous too."""
    regs, order, vals = _bank()
    plan = regpack.plan_pack(vals)
    wide = np.zeros((N, 2 * R), np.uint8)
    wide[:, ::2] = regs
    for bank in (regs, wide[:, ::2]):
        got = screened.upload_sorted_rows(
            bank, order if ordered else None, 5, 96, "cpu",
            slab_bytes=11 * R, threads=threads, pack=plan)
        want = regs[order[5:]] if ordered else regs[5:]
        np.testing.assert_array_equal(got.numpy()[:95], want)
        assert not got.numpy()[95:].any()


def test_packed_upload_needs_whole_bytes():
    regs = np.zeros((4, 12), np.uint8)
    with pytest.raises(ValueError, match="multiple of 8"):
        screened.upload_sorted_rows(regs, None, 0, 4, "cpu",
                                    pack=regpack.plan_pack([0]))


class _PackedJaxPlan(jscreened.ScreenPlan):
    """The JAX plan with its upload_pack override set, as a user sets the
    attribute before the lazy upload."""
    upload_pack = True


def _plans(crit, n, ti):
    jb = (jax_bank_hll(n, 10, 6, 23) if crit.startswith("hll")
          else jax_bank(n, 10, 16, 29))
    params = dict(tau=0.5, criterion=crit)
    return (jb, _PackedJaxPlan(jb, JParams(**params), ti),
            screened.ScreenPlan(port_bank(jb), SelectionParams(**params), ti,
                                device="cpu", upload_pack=True))


@pytest.mark.parametrize("crit", ["smh_a", "hll_a"])
def test_packed_plan_rows_match_jax(crit):
    """ScreenPlan(upload_pack=True): the bank read through d_rows equals
    the packed JAX plan's d_regs; its pack plan is the JAX plan's; the
    primary bank went packed, the aux banks raw."""
    jb, jp, pp = _plans(crit, 70, 16)
    want = np.asarray(jp.d_regs)
    assert jp.upload_stats["pack_bits"] == pp.upload_stats["pack_bits"] > 0
    np.testing.assert_array_equal(pp.d_bank[pp.d_rows.long()].numpy(), want)
    raw = np.zeros((71, jb.regs.shape[1]), np.uint8)
    raw[:70] = jb.regs
    np.testing.assert_array_equal(pp.d_bank.numpy(), raw)
    for a, b in zip(pp.pack_plan, jp._pack_plan):
        np.testing.assert_array_equal(a, b)
    assert set(pp.upload_stats) == set(jp.upload_stats) == \
        UPLOAD_KEYS | {"wire_wait_secs"}
    assert pp.upload_stats["gather_secs"] == 0.0
    assert 0.0 < pp.presence_secs < pp.upload_secs
    if crit == "hll_a":
        np.testing.assert_array_equal(pp.d_aux_regs.numpy(),
                                      np.asarray(jp.d_aux_regs))


@pytest.mark.parametrize("upload_pack", [None, False])
def test_plan_ships_raw_unless_asked(upload_pack):
    jb = jax_bank(30, 10, 16, 29)
    pp = screened.ScreenPlan(port_bank(jb), SelectionParams(tau=0.5), 16,
                             device="cpu", upload_pack=upload_pack)
    assert pp.pack_plan is None and pp.presence_secs < 1e-3
    assert pp.upload_stats["pack_bits"] == 0
    assert pp.upload_stats["pack_secs"] == 0.0


@pytest.mark.parametrize("fault", ["alphabet", "decode"])
def test_packed_plan_refuses_values_off_the_alphabet(monkeypatch, fault):
    """The plan holds row_hist's values of the decoded bank to the host
    alphabet: an alphabet that names a value the bank lacks, and a decode
    that writes a register off the alphabet, both raise."""
    jb = jax_bank(30, 10, 16, 29)
    vals = jscreen.bank_values(jb.regs)
    if fault == "alphabet":
        monkeypatch.setattr(regpack, "host_values",
                            lambda regs: vals + (vals[-1] + 1,))
    else:
        unpack = regpack.unpack_rows

        def faulty(out, packed, table, i0, k):
            unpack(out, packed, table, i0, k)
            out[i0, 0] = vals[-1] + 1
            return out

        monkeypatch.setattr(regpack, "unpack_rows", faulty)
    with pytest.raises(RuntimeError, match="host alphabet"):
        screened.ScreenPlan(port_bank(jb), SelectionParams(tau=0.5), 16,
                            device="cpu", upload_pack=True)


@pytest.mark.parametrize("crit", ["smh_a", "hll_a"])
def test_packed_select_pairs_matches_jax(monkeypatch, crit):
    """select_pairs_screened(upload_pack=True) gives the packed JAX
    engine's lines and the raw route's."""
    jb = (jax_bank_hll(40, 10, 6, 31) if crit == "hll_a"
          else jax_bank(40, 10, 16, 37))
    monkeypatch.setattr(jscreened, "ScreenPlan", _PackedJaxPlan)
    want = jscreened.select_pairs_screened(jb, JParams(tau=0.1,
                                                       criterion=crit),
                                           ti=16, chunk=4)
    params = SelectionParams(tau=0.1, criterion=crit)
    got = screened.select_pairs_screened(port_bank(jb), params, ti=16,
                                         chunk=4, device="cpu",
                                         upload_pack=True)
    raw = screened.select_pairs_screened(port_bank(jb), params, ti=16,
                                         chunk=4, device="cpu")
    assert got == want == raw
    assert len(got) > 0


@pytest.mark.parametrize("crit", ["smh_a", "hll_a"])
@pytest.mark.parametrize("n_dev", [1, 3])
def test_ring_packed_strips_equal_raw(monkeypatch, crit, n_dev):
    """select_pairs_ring(upload_pack=True): the register strips went
    packed and equal the raw route's strips, the aux strips went raw, and
    the lines are the raw route's and the JAX ring's."""
    jb = (jax_bank_hll(48, 10, 6, 23) if crit == "hll_a"
          else jax_bank(48, 10, 16, 29))
    uploads = []

    def spy(bank_regs, order, lo, rows_out, *a, **kw):
        out = screened.upload_sorted_rows(bank_regs, order, lo, rows_out,
                                          *a, **kw)
        uploads.append((bank_regs, kw.get("pack"), out.clone()))
        return out

    monkeypatch.setattr(ring, "upload_sorted_rows", spy)
    params = SelectionParams(tau=0.5, criterion=crit)
    pb = port_bank(jb)
    runs = {}
    for pack in (True, None):
        uploads.clear()
        stats = {}
        lines = ring.select_pairs_ring(pb, params,
                                       mesh=row_mesh(["cpu"] * n_dev), ti=8,
                                       stats=stats, upload_pack=pack)
        runs[pack] = (lines, stats, list(uploads))
    (lp, sp, up), (lr, sr, ur) = runs[True], runs[None]
    assert lp == lr == jring.select_pairs_ring(
        jb, JParams(tau=0.5, criterion=crit), ti=8)
    assert sp["upload_stats"]["pack_bits"] > 0 == sr["upload_stats"][
        "pack_bits"]
    assert set(sp["upload_stats"]) == UPLOAD_KEYS
    assert len(up) == len(ur) == n_dev * (2 if crit == "hll_a" else 1)
    for (src, pack, got), (_, raw_pack, want) in zip(up, ur):
        assert raw_pack is None
        assert (pack is not None) == (src is pb.regs)
        assert torch.equal(got, want)
