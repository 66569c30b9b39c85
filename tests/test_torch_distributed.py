"""The port's multi-host tile slices (parallel/distributed.py) against the
JAX package's: tile_slice, select_pairs_multihost over explicit slices
merged in the reference's row order, and one real two-process run under
torch.distributed (gloo, a file:// rendezvous under the test's temporary
directory, no port to race for)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_banks import (jax_bank, jax_bank_hll, one_torch_thread,  # noqa
                         port_bank, rounded)

from cuda_selection_criteria_tpu.parallel import distributed as jdist
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu_torch.parallel import distributed, screened
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("n_tiles", [0, 1, 7, 100, 1001])
def test_tile_slice_matches_jax(n_tiles):
    """Explicit slices tile [0, n) in order, as the reference's; without a
    process group a process owns everything."""
    for count in (1, 2, 3, 8):
        got = [distributed.tile_slice(n_tiles, i, count)
               for i in range(count)]
        assert got == [jdist.tile_slice(n_tiles, i, count)
                       for i in range(count)]
        assert got[0][0] == 0 and got[-1][1] == n_tiles
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert distributed.tile_slice(n_tiles) == (0, n_tiles)


def test_initialize_without_an_address_is_a_no_op():
    distributed.initialize()
    assert not torch.distributed.is_initialized()


def _shards(bank, params, n_proc, ti, chunk, monkeypatch, mod=distributed):
    orig = mod.tile_slice
    shards = []
    for pid in range(n_proc):
        monkeypatch.setattr(mod, "tile_slice",
                            lambda n, i=None, c=None, _p=pid: orig(n, _p,
                                                                   n_proc))
        kw = dict(device="cpu") if mod is distributed else {}
        shards.append(mod.select_pairs_multihost(bank, params, ti=ti,
                                                 chunk=chunk, **kw))
    monkeypatch.setattr(mod, "tile_slice", orig)
    return shards


@pytest.mark.parametrize("crit,tau,n_proc", [
    ("smh_a", 0.15, 3), ("cb", 0.15, 3), ("hll_a", 0.1, 2),
    ("hll_an", 0.1, 3)])
def test_multihost_slices_merge_to_the_single_engine(crit, tau, n_proc,
                                                     monkeypatch):
    """tests/test_multichip.py:50 and tests/test_sharded_engines.py:197 on
    the port: the shards of explicit slices are disjoint, each equal to the
    reference's shard of the same slice, and merge to the single-device
    engine's lines."""
    jb = (jax_bank_hll(40, 10, 6, 61) if crit.startswith("hll")
          else jax_bank(40, 10, 16, 41))
    bank = port_bank(jb)
    params = SelectionParams(tau=tau, criterion=crit)
    shards = _shards(bank, params, n_proc, 16, 2, monkeypatch)
    jshards = _shards(jb, JParams(tau=tau, criterion=crit), n_proc, 16, 2,
                      monkeypatch, jdist)
    for s, js in zip(shards, jshards):
        assert [t[:2] for t in s] == [t[:2] for t in js]
        assert rounded([t[2:] for t in s]) == rounded([t[2:] for t in js])
    keys = [{t[:2] for t in s} for s in shards]
    assert sum(map(len, keys)) == len(set().union(*keys))
    assert sum(bool(k) for k in keys) >= 2
    single = screened.select_pairs_screened(bank, params, ti=16, chunk=2,
                                            device="cpu")
    merged = distributed.merge_multihost_results(shards)
    assert rounded(merged) == rounded(single) == rounded(
        jscreened.select_pairs_screened(jb, JParams(tau=tau, criterion=crit),
                                        ti=16, chunk=2))
    assert len(single) > 0


_WORKER = r"""
import json, sys
import numpy as np
rank, world, init, bank_path, out_path, root = sys.argv[1:7]
sys.path.insert(0, root)
from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.parallel import distributed
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)

distributed.initialize(init_method=init, world_size=int(world),
                       rank=int(rank), backend="gloo")
import torch.distributed as dist
assert dist.get_rank() == int(rank) and dist.get_world_size() == int(world)
z = np.load(bank_path)
bank = SketchBank.from_arrays(
    names=[str(s) for s in z["names"]], regs=z["regs"], p=int(z["p"]),
    cards=z["cards"], aux=z["aux"], aux_kind="smh", aux_param=16)
shard = distributed.select_pairs_multihost(
    bank, SelectionParams(tau=0.15, criterion="smh_a"), ti=16, chunk=2,
    device="cpu")
with open(out_path, "w") as fh:
    json.dump(shard, fh)
dist.barrier()
dist.destroy_process_group()
"""


def test_two_process_gloo_multihost(tmp_path):
    """Two OS processes join a gloo process group through a file://
    rendezvous, each screens the tile slice its rank owns, and the merged
    shards are the single engine's lines (port and reference)."""
    jb = jax_bank(40, 10, 16, 41)
    bank_path = str(tmp_path / "bank.npz")
    np.savez(bank_path, names=np.array(jb.names), regs=jb.regs, p=jb.p,
             cards=jb.cards, aux=jb.aux)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    init = f"file://{tmp_path / 'rendezvous'}"
    outs = [str(tmp_path / f"shard{r}.json") for r in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), "2", init, bank_path, outs[r],
         ROOT], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(2)]
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err.decode()[-4000:]
    finally:
        for proc in procs:
            proc.kill()
    shards = [[tuple(t) for t in json.load(open(o))] for o in outs]
    keys = [{t[:2] for t in s} for s in shards]
    assert not keys[0] & keys[1]
    bank = port_bank(jb)
    params = SelectionParams(tau=0.15, criterion="smh_a")
    single = screened.select_pairs_screened(bank, params, ti=16, chunk=2,
                                            device="cpu")
    merged = distributed.merge_multihost_results(shards)
    assert rounded(merged) == rounded(single) == rounded(
        jscreened.select_pairs_screened(
            jb, JParams(tau=0.15, criterion="smh_a"), ti=16, chunk=2))
    assert len(single) > 0
