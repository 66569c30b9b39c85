"""The port's slab-pipelined sorted upload (parallel/screened.
upload_sorted_rows) against the JAX package's (pack=None, CPU backend),
and the banks it gives the screened plan and the ring: every comparison
is bit-equality of the uploaded rows, and the stats carry the reference's
keys. The card's side (pinned arenas, the event guard, the plan-stage
peak) is in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from cuda_selection_criteria_tpu.parallel import ring as jring
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu_torch.parallel import ring, screened
from cuda_selection_criteria_tpu_torch.parallel.mesh import row_mesh
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)
from torch_banks import jax_bank, jax_bank_hll, port_bank

N, R = 100, 64  # bank rows and bytes a row
UPLOAD_KEYS = {"slabs", "gather_secs", "put_ret_secs", "token_wait_secs",
               "pack_secs", "pack_bits"}


def _bank():
    rng = np.random.default_rng(11)
    return (rng.integers(0, 40, (N, R), dtype=np.uint8),
            rng.permutation(N))


@pytest.mark.parametrize("lo,rows_out,slab_rows", [
    (0, 128, 1 << 20),  # the whole bank in one slab, padded
    (0, 100, 10),       # whole slabs, no padding
    (37, 48, 7),        # mid-bank, the last slab part-filled
    (64, 64, 9),        # rows_out beyond count: 36 rows, 28 zero
    (90, 30, 1),        # one-row slabs
    (100, 16, 8),       # count == 0: all zero
    (130, 4, 8),        # lo past the bank: all zero
])
def test_upload_sorted_rows_matches_jax(lo, rows_out, slab_rows):
    regs, order = _bank()
    want_stats, got_stats = {}, {}
    want = np.asarray(jscreened.upload_sorted_rows(
        regs, order, lo, rows_out, slab_bytes=slab_rows * R,
        stats=want_stats))
    got = screened.upload_sorted_rows(regs, order, lo, rows_out, "cpu",
                                      slab_bytes=slab_rows * R,
                                      stats=got_stats)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    count = max(0, min(N - lo, rows_out))
    np.testing.assert_array_equal(got.numpy()[:count],
                                  regs[order[lo:lo + count]])
    assert not got.numpy()[count:].any()
    assert set(got_stats) == set(want_stats)
    if count:
        assert set(got_stats) == UPLOAD_KEYS
        assert got_stats["slabs"] == want_stats["slabs"] == \
            -(-count // slab_rows)
        assert got_stats["pack_bits"] == 0 and got_stats["pack_secs"] == 0.0


@pytest.mark.parametrize("threads", [1, 3, 16])
def test_upload_threads_give_the_same_rows(threads):
    """The slab's gather shared by host threads (more threads than rows a
    slab included) gives the one-thread bytes."""
    regs, order = _bank()
    got = screened.upload_sorted_rows(regs, order, 5, 96, "cpu",
                                      slab_bytes=11 * R, threads=threads)
    np.testing.assert_array_equal(got.numpy()[:95], regs[order[5:]])
    assert not got.numpy()[95:].any()


def test_upload_stats_accumulate_like_jax():
    """One stats dict over two uploads (the ring's strips): slabs add up,
    in both packages."""
    regs, order = _bank()
    want, got = {}, {}
    for lo in (0, 50):
        jscreened.upload_sorted_rows(regs, order, lo, 50, slab_bytes=8 * R,
                                     stats=want)
        screened.upload_sorted_rows(regs, order, lo, 50, "cpu",
                                    slab_bytes=8 * R, stats=got)
    assert got["slabs"] == want["slabs"] == 14
    assert set(got) == set(want)


def _plans(crit, n, ti):
    jb = (jax_bank_hll(n, 10, 6, 23) if crit.startswith("hll")
          else jax_bank(n, 10, 16, 29))
    params = dict(tau=0.5, criterion=crit)
    return (jb, jscreened.ScreenPlan(jb, JParams(**params), ti),
            screened.ScreenPlan(port_bank(jb), SelectionParams(**params), ti,
                                device="cpu"))


def _padded(x, order, n_pad):
    out = np.zeros((n_pad, x.shape[1]), np.uint8)
    out[:len(order)] = x[order]
    return out


@pytest.mark.parametrize("crit", ["smh_a", "hll_a"])
def test_plan_device_banks_are_sorted_rows(crit):
    """ScreenPlan's device bank read through its row map (and for hll_a
    d_aux_regs) equals the sorted rows zero-padded to a tile multiple, and
    the JAX plan's d_regs; the bank itself is the rows in their own order
    and one zero row; upload_stats has the JAX plan's keys."""
    jb, jp, pp = _plans(crit, 70, 16)
    assert pp.n_pad == 80
    want = _padded(jb.regs, pp.order, pp.n_pad)
    np.testing.assert_array_equal(pp.d_bank.numpy(),
                                  _padded(jb.regs, np.arange(70), 71))
    assert pp.d_rows.dtype == torch.int32
    sorted_rows = pp.d_bank[pp.d_rows.long()].numpy()
    np.testing.assert_array_equal(sorted_rows, want)
    np.testing.assert_array_equal(sorted_rows, np.asarray(jp.d_regs))
    assert set(pp.upload_stats) == set(jp.upload_stats) == \
        UPLOAD_KEYS | {"wire_wait_secs"}
    assert pp.upload_stats["slabs"] == 1 and pp.upload_secs > 0.0
    if crit == "hll_a":
        np.testing.assert_array_equal(pp.d_aux_regs.numpy(),
                                      _padded(jb.aux, pp.order, pp.n_pad))
        np.testing.assert_array_equal(pp.d_aux_regs.numpy(),
                                      np.asarray(jp.d_aux_regs))


@pytest.mark.parametrize("crit", ["smh_a", "hll_a"])
@pytest.mark.parametrize("n_dev", [1, 3])
def test_ring_strips_are_sorted_rows(monkeypatch, crit, n_dev):
    """The ring's strips, through upload_sorted_rows, laid end to end are
    the sorted rows zero-padded to whole strips (registers, and for hll_a
    the aux registers); the ring's upload_stats has the JAX ring's keys
    and one slab a strip; its lines are the JAX ring's."""
    jb, _, pp = _plans(crit, 48, 16)
    uploads = []

    def spy(bank_regs, order, lo, rows_out, *a, **kw):
        out = screened.upload_sorted_rows(bank_regs, order, lo, rows_out,
                                          *a, **kw)
        uploads.append((bank_regs, lo, out.clone()))
        return out

    monkeypatch.setattr(ring, "upload_sorted_rows", spy)
    params = SelectionParams(tau=0.5, criterion=crit)
    stats, jstats = {}, {}
    got = ring.select_pairs_ring(port_bank(jb), params,
                                 mesh=row_mesh(["cpu"] * n_dev), ti=8,
                                 stats=stats)
    want = jring.select_pairs_ring(jb, JParams(tau=0.5, criterion=crit),
                                   ti=8, stats=jstats)
    assert [(a, b, round(j, 12)) for a, b, j in got] == \
        [(a, b, round(j, 12)) for a, b, j in want]
    strip = stats["strip"]
    for src in ([jb.regs, jb.aux] if crit == "hll_a" else [jb.regs]):
        strips = [out for x, _, out in uploads if x is src]
        assert [lo for x, lo, _ in uploads if x is src] == \
            [d * strip for d in range(n_dev)]
        np.testing.assert_array_equal(
            torch.cat(strips).numpy(),
            _padded(src, pp.order, strip * n_dev))
    assert set(stats["upload_stats"]) == set(jstats["upload_stats"]) == \
        UPLOAD_KEYS
    assert stats["upload_stats"]["slabs"] == n_dev
