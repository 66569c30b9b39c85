"""The port's tile-sharded screened engine and dense mesh engine
(parallel/screened.select_pairs_screened_sharded, parallel/mesh) against
the JAX package's on its eight virtual CPU devices, with the port on meshes
of CPU devices that repeat one device; ScreenPlan.screen_tiles's spans, the
device mesh and the auto engine's ring rule. Every comparison is exact:
output lines equal after torch_banks.rounded, checkpoint files equal line
for line."""

import functools
import json

import numpy as np
import pytest
import torch

from torch_banks import (jax_bank, jax_bank_hll, one_torch_thread,  # noqa
                         port_bank, rounded)

from cuda_selection_criteria_tpu.parallel import mesh as jmesh
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu_torch.parallel import (mesh, screened,
                                                        selection)
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)
from cuda_selection_criteria_tpu_torch.utils.hostref import select_pairs_host

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CRITERIA = [("smh_a", 0.15), ("smh_only", 0.15), ("cb", 0.15),
            ("baseline", 0.15), ("hll_a", 0.1), ("hll_an", 0.1)]


def _bank(crit, n):
    return (jax_bank_hll(n, 10, 6, 31) if crit.startswith("hll")
            else jax_bank(n, 10, 16, 47))


def _host(bank, crit, tau):
    return rounded(select_pairs_host(
        bank, tau, crit, apply_cb=crit not in ("baseline", "smh_only")))


@functools.lru_cache(maxsize=None)
def _jax_sharded(crit, tau):
    jb = _bank(crit, 48)
    return jb, rounded(jscreened.select_pairs_screened_sharded(
        jb, JParams(tau=tau, criterion=crit), ti=8, chunk=16))


@pytest.mark.parametrize("n_dev", [3, 8])
@pytest.mark.parametrize("crit,tau", CRITERIA)
def test_sharded_screened_matches_jax_and_host(crit, tau, n_dev):
    """Every criterion on the tile-sharded engine, tiles of 8 rows split
    over 3 and 8 CPU devices: the reference engine's lines (8 virtual
    devices) and the host reference's."""
    jb, want = _jax_sharded(crit, tau)
    bank = port_bank(jb)
    got = rounded(screened.select_pairs_screened_sharded(
        bank, SelectionParams(tau=tau, criterion=crit),
        mesh=mesh.row_mesh(["cpu"] * n_dev), ti=8, chunk=16))
    assert got == want == _host(bank, crit, tau) and len(got) >= 4


def _spans(path):
    return [json.loads(ln)["span"] for ln in open(path).read().splitlines()[1:]]


def test_sharded_checkpoint_resume(tmp_path):
    """tests/test_sharded_engines.py:127-162 on the port: the sharded
    engine runs the single-device chunk, wave and checkpoint loop, every
    launch a multiple of the device count and at most the chunk; a run cut
    to two records and a torn line resumes to the same lines; another chunk
    refuses the file. The file equals the reference engine's."""
    jb = jax_bank(48, 10, 16, 29)
    bank = port_bank(jb)
    params = SelectionParams(tau=0.15, criterion="smh_a")
    m8 = mesh.row_mesh(["cpu"] * 8)
    ckpt = str(tmp_path / "sweep.jsonl")
    plain = screened.select_pairs_screened_sharded(bank, params, m8, ti=8,
                                                   chunk=8)
    first = screened.select_pairs_screened_sharded(bank, params, m8, ti=8,
                                                   chunk=8, checkpoint=ckpt)
    assert rounded(plain) == rounded(first) and len(plain) > 0
    jckpt = str(tmp_path / "jax.jsonl")
    jscreened.select_pairs_screened_sharded(
        jb, JParams(tau=0.15, criterion="smh_a"), ti=8, chunk=8,
        checkpoint=jckpt)
    lines = open(ckpt).read().splitlines()
    assert [json.loads(ln) for ln in lines] == \
        [json.loads(ln) for ln in open(jckpt).read().splitlines()]
    spans = _spans(ckpt)
    assert len(spans) > 2
    assert all(w % 8 == 0 and w <= 8 for _, w in spans)
    with open(ckpt, "w") as fh:
        fh.write("\n".join(lines[:3]) + '\n{"span": [999')
    resumed = screened.select_pairs_screened_sharded(
        bank, params, m8, ti=8, chunk=8, checkpoint=ckpt)
    assert rounded(resumed) == rounded(plain)
    with pytest.raises(ValueError, match="different run"):
        screened.select_pairs_screened_sharded(bank, params, m8, ti=8,
                                               chunk=16, checkpoint=ckpt)


@pytest.mark.parametrize("quantum,chunk", [(1, 64), (1, 5), (3, 8), (8, 8),
                                           (8, 20)])
def test_screen_tiles_spans_match_jax(tmp_path, quantum, chunk):
    """ScreenPlan.screen_tiles's launch spans: the defaults (quantum 1)
    give the single-device spans, a quantum rounds every width to its
    multiple, both as the reference's screen_tiles; recorded through the
    checkpoint files, which must be equal line for line."""
    jb = jax_bank(70, 10, 16, 41)
    crit = JParams(tau=0.2, criterion="smh_a")
    jplan = jscreened.ScreenPlan(jb, crit, 8)
    plan = screened.ScreenPlan(port_bank(jb), SelectionParams(
        tau=0.2, criterion="smh_a"), 8, device="cpu")
    rows, cols = plan.schedule()
    files = [str(tmp_path / f"{k}.jsonl") for k in ("port", "jax")]
    kw = dict(chunk=chunk, quantum=quantum) if quantum > 1 else dict(
        chunk=chunk)
    cand = plan.screen_tiles(rows, cols, checkpoint=files[0], **kw)
    jcand = jplan.screen_tiles(rows, cols, checkpoint=files[1], **kw)
    assert cand == jcand and len(cand) > 0
    port, ref = ([json.loads(ln) for ln in open(f).read().splitlines()]
                 for f in files)
    assert port == ref
    widths = [w for _, w in _spans(files[0])]
    assert all(w % quantum == 0 for w in widths)
    if quantum == 1:  # the single-device rule: full chunks, a pow2 bucket
        full = min(chunk, len(rows))
        rem = len(rows) % full
        assert widths == [full] * (len(rows) // full) + (
            [min(full, max(8, 1 << (rem - 1).bit_length()))] if rem else [])


@functools.lru_cache(maxsize=None)
def _dense_bank(crit):
    return (jax_bank_hll(24, 10, 6, 59) if crit.startswith("hll")
            else jax_bank(24, 10, 16, 59))


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 4)])
@pytest.mark.parametrize("crit,tau", CRITERIA)
def test_dense_mesh_matches_jax(crit, tau, shape):
    """select_pairs_sharded on (rows, regs) meshes of CPU devices: lines
    equal to the reference's dense mesh engine on the same mesh of its
    virtual devices, and to the host reference."""
    jb = _dense_bank(crit)
    bank = port_bank(jb)
    want = rounded(jmesh.select_pairs_sharded(
        jb, JParams(tau=tau, criterion=crit), jmesh.make_mesh(*shape)))
    got = rounded(mesh.select_pairs_sharded(
        bank, SelectionParams(tau=tau, criterion=crit),
        mesh.make_mesh(*shape, devices=["cpu"] * 8)))
    assert got == want == _host(bank, crit, tau) and len(got) >= 2


@pytest.mark.parametrize("crit", ["smh_a", "cb"])
def test_dense_mesh_unadjudicated_jaccards_match_jax(crit):
    """adjudicate=False: the emitted pairs and the device f64 Jaccards of
    the mesh step, bit-equal to the reference's."""
    jb = _dense_bank(crit)
    got = mesh.select_pairs_sharded(
        port_bank(jb), SelectionParams(tau=0.1, criterion=crit,
                                       adjudicate=False),
        mesh.make_mesh(4, 2, devices=["cpu"] * 8))
    want = jmesh.select_pairs_sharded(
        jb, JParams(tau=0.1, criterion=crit, adjudicate=False),
        jmesh.make_mesh(4, 2))
    assert got == want and len(got) >= 2


def test_sharded_smh_step_matches_general_step():
    """The 9-argument smh_a step is the general step with no aux gate."""
    jb = _dense_bank("smh_a")
    order = jb.sorted_by_cardinality()
    regs = torch.from_numpy(jb.regs[order])
    aux = torch.from_numpy(jb.aux[order].view(np.int64))
    e = torch.from_numpy(np.trunc(jb.cards[order]))
    idx = torch.arange(24)
    m = mesh.make_mesh(2, 2, devices=["cpu"] * 4)
    args = (regs, regs, aux, aux, e, e, idx, idx, 0.1)
    got = mesh.sharded_smh_selection_step(m, 10, 2, 8)(*args)
    want = mesh.sharded_selection_step(m, 10, "smh_a", 2, 8)(*args, 0.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (24, 24) and got[0].any()


def test_make_mesh_shapes(monkeypatch):
    """The reference's axis rule; a mesh over CPU devices repeats one;
    without a card the default mesh raises instead of taking the CPU."""
    m = mesh.make_mesh(devices=["cpu"] * 8)
    assert m.shape == {"rows": 4, "regs": 2}
    assert mesh.make_mesh(n_rows=8, devices=["cpu"] * 8).shape == {
        "rows": 8, "regs": 1}
    assert mesh.make_mesh(n_regs=4, devices=["cpu"] * 8).shape["rows"] == 2
    assert mesh.make_mesh(devices=["cpu"] * 3).shape == {"rows": 3,
                                                         "regs": 1}
    assert m.devices("rows") == [torch.device("cpu")] * 4
    assert len(m.devices()) == 8
    with pytest.raises(ValueError, match="3x2"):
        mesh.make_mesh(3, 2, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.resolve_mesh(None)
    r, dev = mesh.resolve_mesh(None, "cpu")
    assert r.shape == {"rows": 1} and dev == torch.device("cpu")


def test_replicate_bank_copies_once_per_device():
    """A device that appears several times in the mesh shares one copy."""
    t = torch.arange(6)
    reps = screened.replicate_bank(mesh.row_mesh(["cpu"] * 4), t, None)
    assert len(reps) == 4 and all(r is reps[0] for r in reps)
    assert reps[0][0] is t and reps[0][1] is None


def test_auto_engine_takes_the_ring_past_replication(monkeypatch):
    """engine="auto" on several cards: the ring when the bank exceeds
    RING_BANK_SHARE of one card's memory, the screened engine below it
    and on one card (the reference's rule; card properties faked here)."""
    calls = []
    monkeypatch.setattr(selection, "select_pairs_ring",
                        lambda *a, **k: calls.append("ring") or [])
    monkeypatch.setattr(selection, "select_pairs_screened",
                        lambda *a, **k: calls.append("screened") or [])

    class Props:
        total_memory = 20 * 1024  # bytes: a 24 x 1024 bank is above 0.55x

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    bank = port_bank(_dense_bank("cb"))
    params = SelectionParams(tau=0.5, criterion="cb")
    for count in (1, 2):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        selection.select_pairs(bank, params)
    Props.total_memory = 1 << 30
    selection.select_pairs(bank, params)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    selection.select_pairs(bank, params, device="cuda:0")
    assert calls == ["screened", "ring", "screened", "screened"]
    assert "ring" in selection.ENGINES
