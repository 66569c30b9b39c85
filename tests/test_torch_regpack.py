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


# csrc/regpack_unpack.cu's launch: threads a CTA of each path, and the
# byte path's CTAs an SM (the word path gives every group a thread)
WORD_THREADS = BYTE_THREADS = 256
BYTE_BLOCKS_PER_SM = 16
U32 = 0xFFFFFFFF


def _byte_perm(x, y, sel):
    """numpy model of __byte_perm(x, y, sel) on uint32 arrays, for
    selectors without the sign mode: byte n of the result is byte
    (nibble n of sel) of the 8 bytes y:x."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def _model_path(r8, src, dst):
    """The kernel's host choice (word_path): the word path for R/8 a
    multiple of 4 (W = R/32 below 2^31), planes 4-byte aligned and out at
    row i0 16-byte aligned; the byte path otherwise."""
    word = (r8 % 4 == 0 and r8 // 4 <= 2**31 - 1 and src % 4 == 0
            and dst % 16 == 0)
    return "word" if word else "byte"


def _walk(groups, width, stride, plane_row):
    """The grid-stride walk of either path: for each thread's first group
    g0, the group's row and column (word or byte) from one division, then
    the source advanced by the stride's own quotient and remainder, plus
    plane_row - width when the column wraps (no division in the loop).
    Returns (source offset of plane 0, destination block) of every group
    in the order the threads visit them; checks that each source is the
    group's own and that every group is visited once."""
    src_of = np.empty(groups, np.int64)
    seen = np.zeros(groups, np.int64)
    ds, dc = divmod(stride, width)
    for g0 in range(min(stride, groups)):
        s0, c = divmod(g0, width)
        src = s0 * plane_row + c
        for g in range(g0, groups, stride):
            gs, gc = divmod(g, width)
            assert src == gs * plane_row + gc
            src_of[g] = src
            seen[g] += 1
            src += ds * plane_row + dc
            c += dc
            if c >= width:
                c -= width
                src += plane_row - width
    assert (seen == 1).all()
    return src_of


def _index_byte(x, c):
    """Byte c of the index words, as the kernel takes it: a mask, a shift
    or a __byte_perm with zeros."""
    if c == 0:
        return x & 0xFF
    if c == 3:
        return x >> 24
    return _byte_perm(x, np.zeros_like(x), 0x4440 | c)


def _word_model(packed, table, k, blocks):
    """The word path: group g (row g // W, word g % W, W = R/32) loads one
    little-endian 4-byte word of each plane; for each bit b and plane j a
    shift by b - j and a mask of bit j of each byte (one SHF and one LOP3)
    gather x[b], whose byte c is the index of register 8c + b; each index
    byte is looked up in the table, and three __byte_perm a word put the
    values of registers 8c + 4h .. + 3 into word 2c + h; the 8 words are
    32-byte block g of out."""
    s, _, r8 = packed.shape
    width = r8 // 4
    groups = s * width
    words = packed.reshape(-1).view("<u4").astype(np.uint64)
    src = _walk(groups, width, blocks * WORD_THREADS, k * width)
    p = [words[src + j * width] for j in range(k)]
    x = []
    for b in range(8):
        acc = np.zeros(groups, np.uint64)
        for j in range(k):
            t = p[j] >> (b - j) if b >= j else (p[j] << (j - b)) & U32
            acc |= t & (0x01010101 << j)
        x.append(acc)
    tab = table.astype(np.uint64)
    out = np.zeros((groups, 8), np.uint64)
    for h in range(2):
        v = [[tab[_index_byte(x[4 * h + t], c)] for c in range(4)]
             for t in range(4)]
        for c in range(4):
            lo = _byte_perm(v[0][c], v[1][c], 0x0040)
            hi = _byte_perm(v[2][c], v[3][c], 0x0040)
            out[:, 2 * c + h] = _byte_perm(lo, hi, 0x5410)
    return out.astype("<u4").view(np.uint8).reshape(s, 8 * r8)


def _byte_model(packed, table, k, blocks):
    """The byte path (the replaced design's loop): group g (row
    g // (R/8), byte g % (R/8)) spreads its byte of each plane to 8 bytes
    by the nibble multiply, looks the 8 indices up in the table and writes
    one little-endian 8-byte word, word g of out."""
    s, _, r8 = packed.shape
    groups = s * r8
    flat = packed.reshape(-1).astype(np.uint64)
    src = _walk(groups, r8, blocks * BYTE_THREADS, k * r8)

    def spread4(n):
        return (n * 0x00204081) & 0x01010101

    idx = np.zeros(groups, np.uint64)
    for j in range(k):
        b = flat[src + j * r8]
        idx |= (spread4(b & 0xF) | spread4(b >> 4) << 32) << j
    tab = table.astype(np.uint64)
    out = np.zeros(groups, np.uint64)
    for bi in range(8):
        out |= tab[(idx >> (8 * bi)) & 0x7F] << (8 * bi)
    return out.astype("<u8").view(np.uint8).reshape(s, 8 * r8)


def _launch_blocks(path, s, r8, sms):
    """The kernel's own grid on a card of `sms` SMs: one group a thread on
    the word path, at most BYTE_BLOCKS_PER_SM CTAs an SM on the byte
    path."""
    if path == "word":
        return -(-s * (r8 // 4) // WORD_THREADS)
    return min(-(-s * r8 // BYTE_THREADS), sms * BYTE_BLOCKS_PER_SM)


def _kernel_model(packed, table, k, blocks=None, src=0, dst=0, sms=132):
    """numpy model of csrc/regpack_unpack.cu: the host's choice of path
    from the shape and the planes' and destination's addresses (src,
    dst), then that path's walk (over `blocks` CTAs, or the kernel's own
    grid on `sms` SMs) and arithmetic. Returns (path, rows)."""
    s, _, r8 = packed.shape
    path = _model_path(r8, src, dst)
    if blocks is None:
        blocks = _launch_blocks(path, s, r8, sms)
    model = _word_model if path == "word" else _byte_model
    return path, model(packed, table, k, blocks)


def _model_case(k, r, s, seed):
    rng = np.random.default_rng(seed)
    vals = sorted(rng.choice(np.arange(1, 200), (1 << k) - (k > 1),
                             replace=False).tolist())
    lut, table, kk = regpack.plan_pack(vals)
    assert kk == k
    rows = _rows(rng, vals, (s, r))
    return rows, regpack.pack_rows(rows, lut, k), table


# (k, registers a row, rows, CTAs): R/8 of 1, 17, 3, 5 bytes and 2049
# take the byte path; the word path at every k, W = R/32 of 1 to 7 words,
# group counts not a multiple of a CTA's threads and strides of one CTA
# that are not a multiple of W (so the walk wraps)
@pytest.mark.parametrize("k,r,s,blocks", [
    (1, 8, 5, 1), (2, 136, 40, 1), (5, 24, 100, 1), (7, 24, 13, 1),
    (6, 8, 600, 1), (3, 40, 77, 2), (6, 16392, 3, 1), (4, 104, 30, 1),
    (1, 32, 300, 1), (2, 64, 150, 2), (3, 96, 200, 1), (4, 160, 77, 1),
    (5, 128, 90, 1), (5, 16384, 3, 1), (6, 224, 100, 1), (6, 96, 9, 1),
    (7, 32, 513, 1)])
def test_unpack_kernel_model_matches_plain(k, r, s, blocks):
    """The kernel's path, arithmetic and walk over the groups (strides that
    are and are not multiples of the groups a row, a grid larger than the
    groups) against _unpack_rows_plain and the JAX unpack_place."""
    rows, packed, table = _model_case(k, r, s, k * r + s)
    want = regpack._unpack_rows_plain(
        torch.zeros((s, r), dtype=torch.uint8), torch.from_numpy(packed),
        torch.from_numpy(table), 0, k).numpy()
    np.testing.assert_array_equal(want, rows)
    path, got = _kernel_model(packed, table, k, blocks)
    assert path == ("word" if r % 32 == 0 else "byte")
    np.testing.assert_array_equal(got, want)
    jax_rows, _ = jregpack.unpack_place(
        jnp.zeros((s, r), jnp.uint8), jnp.asarray(packed),
        jnp.asarray(table), jnp.int32(0), k)
    np.testing.assert_array_equal(got, np.asarray(jax_rows))


@pytest.mark.parametrize("r8,src,dst,path", [
    (4, 0, 0, "word"), (2048, 4, 16, "word"), (2048, 0, 8, "byte"),
    (2048, 0, 24, "byte"), (2048, 2, 0, "byte"), (2049, 0, 0, "byte"),
    (17, 0, 0, "byte"), (1, 0, 0, "byte"), (4 * 2**31, 0, 0, "byte")])
def test_unpack_model_path_by_shape_and_alignment(r8, src, dst, path):
    """The host's choice: the word path only for R/8 a multiple of 4 with
    the planes 4-byte and the destination 16-byte aligned."""
    assert _model_path(r8, src, dst) == path


@pytest.mark.parametrize("k", [1, 5, 6, 7])
def test_unpack_kernel_model_misaligned_takes_byte_path(k):
    """A word-path shape at a destination aligned to 8 bytes but not 16
    (or planes not 4-byte aligned) takes the byte path, with the same
    rows."""
    rows, packed, table = _model_case(k, 256, 37, k)
    for src, dst in ((0, 8), (0, 40), (1, 0), (0, 0)):
        path, got = _kernel_model(packed, table, k, 1, src, dst)
        assert path == ("word" if (src, dst) == (0, 0) else "byte")
        np.testing.assert_array_equal(got, rows)


@pytest.mark.parametrize("k,r,s,sms", [
    (5, 512, 40, 132), (6, 16384, 3, 132), (3, 136, 300, 2),
    (7, 24, 700, 1)])
def test_unpack_kernel_model_own_grid(k, r, s, sms):
    """The kernel's own grid: every group its own thread on the word path
    (one pass of the walk), the byte path's loop over at most 16 CTAs an
    SM (several passes on a card of 1 or 2 SMs)."""
    rows, packed, table = _model_case(k, r, s, k + r + s)
    path, got = _kernel_model(packed, table, k, sms=sms)
    assert path == ("word" if r % 32 == 0 else "byte")
    if path == "word":
        assert _launch_blocks(path, s, r // 8, sms) * WORD_THREADS >= (
            s * r // 32)
    np.testing.assert_array_equal(got, rows)


def test_byte_perm_model():
    """The __byte_perm model on the selectors the kernel uses."""
    x = np.array([0x44332211], np.uint64)
    y = np.array([0x88776655], np.uint64)
    assert _byte_perm(x, y, 0x0040)[0] == 0x11115511
    assert _byte_perm(x, y, 0x5410)[0] == 0x66552211
    assert _byte_perm(x, y, 0x7632)[0] == 0x88774433
    for c in (1, 2):
        assert _index_byte(x, c)[0] == (0x44332211 >> (8 * c)) & 0xFF


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
