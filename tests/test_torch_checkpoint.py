"""Sweep checkpoint/resume, transient-fault retry and the timing helpers
of the port, held against tests/test_checkpoint.py and the JAX package: a
progress file written by either package's screened sweep resumes in the
other with the same result."""

import json
import os

import numpy as np
import pytest
import torch

from torch_banks import jax_bank, one_torch_thread, port_bank  # noqa: F401

from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu_torch.cli import selection as cli
from cuda_selection_criteria_tpu_torch.parallel import screened
from cuda_selection_criteria_tpu_torch.parallel.screened import (
    ScreenPlan, select_pairs_screened)
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams, select_pairs)
from cuda_selection_criteria_tpu_torch.utils import (profiling, resilience,
                                                     timer)

KW = dict(ti=8, chunk=1)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _bank():
    jb = jax_bank(24, 10, 16, 71)
    return jb, port_bank(jb)


def _torn(path, keep):
    """Keep the header and `keep` span records, then a torn line."""
    lines = open(path).read().strip().splitlines()
    with open(path, "w") as fh:
        fh.write("\n".join(lines[:1 + keep]) + "\n")
        fh.write('{"span": [999')
    return lines


def _count_screen_calls(monkeypatch):
    calls = []
    orig = ScreenPlan.screen_chunk

    def counting(self, r_chunk, c_chunk):
        calls.append(len(r_chunk))
        return orig(self, r_chunk, c_chunk)

    monkeypatch.setattr(ScreenPlan, "screen_chunk", counting)
    return calls


def test_checkpointed_sweep_matches_and_resumes(tmp_path, monkeypatch):
    _, bank = _bank()
    params = SelectionParams(tau=0.15, criterion="smh_a")
    ckpt = str(tmp_path / "sweep.jsonl")

    plain = select_pairs_screened(bank, params, device="cpu", **KW)
    with_ckpt = select_pairs_screened(bank, params, device="cpu",
                                      checkpoint=ckpt, **KW)
    assert plain == with_ckpt and plain
    # a crash: the header, 2 span records and a torn final line survive;
    # the resumed run skips the recorded spans and recomputes the rest
    lines = _torn(ckpt, 2)
    assert len(lines) > 3
    calls = _count_screen_calls(monkeypatch)
    resumed = select_pairs_screened(bank, params, device="cpu",
                                    checkpoint=ckpt, **KW)
    assert resumed == plain
    assert len(calls) == len(lines) - 1 - 2

    # a different run refuses the old checkpoint
    with pytest.raises(ValueError, match="different run"):
        select_pairs_screened(bank, SelectionParams(tau=0.2), device="cpu",
                              checkpoint=ckpt, **KW)
    with open(ckpt, "w") as fh:
        fh.write("not json\n")
    with pytest.raises(ValueError, match="corrupt checkpoint header"):
        select_pairs_screened(bank, params, device="cpu", checkpoint=ckpt,
                              **KW)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, monkeypatch, writer):
    """A file written by one package's sweep resumes in the other's: the
    headers compare equal (tau as the raw float, the schedule hash over the
    int32 tile lists) and the result is the same."""
    jb, bank = _bank()
    jparams = JParams(tau=0.15, criterion="smh_a")
    params = SelectionParams(tau=0.15, criterion="smh_a")
    want = jscreened.select_pairs_screened(jb, jparams, **KW)
    paths = {w: str(tmp_path / f"{w}.jsonl") for w in ("jax", "port")}
    jscreened.select_pairs_screened(jb, jparams, checkpoint=paths["jax"],
                                    **KW)
    select_pairs_screened(bank, params, device="cpu",
                          checkpoint=paths["port"], **KW)
    texts = {w: open(path).read() for w, path in paths.items()}
    assert texts["jax"] == texts["port"]
    lines = _torn(paths[writer], 3)
    if writer == "jax":
        calls = _count_screen_calls(monkeypatch)
        got = select_pairs_screened(bank, params, device="cpu",
                                    checkpoint=paths[writer], **KW)
        assert len(calls) == len(lines) - 1 - 3
    else:
        got = jscreened.select_pairs_screened(
            jb, jparams, checkpoint=paths[writer], **KW)
    assert got == want
    assert json.loads(lines[0])["tau"] == 0.15


def test_checkpoint_through_select_pairs_and_cli(tmp_path, capsys):
    """--checkpoint reaches the screened sweep from the CLI and from
    select_pairs(checkpoint=); a rerun on a finished file reads every span
    back."""
    _, bank = _bank()
    ckpt = str(tmp_path / "a.jsonl")
    params = SelectionParams(tau=0.15, criterion="smh_a", engine="screened")
    got = select_pairs(bank, params, device="cpu", checkpoint=ckpt)
    assert got == select_pairs_screened(bank, params, device="cpu")
    assert os.path.getsize(ckpt) > 0

    from cuda_selection_criteria_tpu_torch.utils import formats

    names = []
    for i, (r, a) in enumerate(zip(bank.regs, bank.aux)):
        names.append(str(tmp_path / f"g{i:02d}"))
        formats.write_hll(names[-1] + ".hll", bank.p, r)
        formats.write_smh(names[-1] + ".smh16", a)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(names) + "\n")
    argv = ["-l", str(lst), "-a", "128", "-h", "0.15", "-c", "smh_a",
            "--device", "cpu", "--engine", "screened", "-b", "8"]
    outs = []
    for extra in ([], ["--checkpoint", str(tmp_path / "b.jsonl")],
                  ["--checkpoint", str(tmp_path / "b.jsonl")]):
        capsys.readouterr()
        assert cli.main(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == outs[2] and outs[0]
    assert os.path.getsize(tmp_path / "b.jsonl") > 0


def test_transient_retry_classifier_and_loop():
    assert resilience.is_transient(RuntimeError("FAILED_PRECONDITION: x"))
    assert resilience.is_transient(RuntimeError("UNAVAILABLE: relay"))
    assert not resilience.is_transient(ValueError("bad argument"))
    # a local card: running out of memory is transient, a CUDA context
    # error is sticky and re-raises at once
    assert resilience.is_transient(torch.OutOfMemoryError("CUDA out of memory"))
    sticky = RuntimeError("CUDA error: an illegal memory access was "
                          "encountered (connection to the device lost)")
    assert not resilience.is_transient(sticky)
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        assert not resilience.is_transient(accel("UNAVAILABLE"))

    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return 42

    assert resilience.run_with_transient_retry(flaky, backoff=0.01) == 42
    assert len(attempts) == 2

    def hard():
        attempts.append(1)
        raise sticky

    with pytest.raises(RuntimeError, match="CUDA error"):
        resilience.run_with_transient_retry(hard, backoff=0.01)
    assert len(attempts) == 3

    def always():
        raise RuntimeError("UNAVAILABLE: still down")

    with pytest.raises(RuntimeError, match="still down"):
        resilience.run_with_transient_retry(always, backoff=0.01)
    with pytest.raises(ValueError):
        resilience.run_with_transient_retry(
            lambda: (_ for _ in ()).throw(ValueError("no")), backoff=0.01)


def test_timers_on_cpu_tensors(capsys, tmp_path):
    with profiling.timed("region") as sink:
        sink["x"] = torch.arange(8).sum()
    assert capsys.readouterr().out.startswith("region;")
    got = {}
    with profiling.timed("r2", sink=lambda k, v: got.update({k: v})) as s:
        s["x"] = [torch.ones(3), (torch.zeros(2),)]
    assert got["r2"] >= 0.0

    held = {}
    with timer.device_timer("mm", held) as (h, t):
        y = h.sync(torch.ones(4, 4) @ torch.ones(4, 4))
    assert held["mm"] == t.seconds >= 0.0 and float(y[0, 0]) == 4.0
    with timer.Timer("build") as t2:
        sum(range(1000))
    assert t2.csv_row().startswith("# elapsed time (build): ")
    x = {"a": torch.ones(2)}
    assert timer.block_until_ready(x) is x

    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert prof.key_averages()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_screen_tiles_span_rule_matches_jax():
    """The span list (full chunks, then a power-of-two bucket) is the
    reference's, so checkpoint spans mean the same tiles in both."""
    jb, bank = _bank()
    for n_live, chunk in ((13, 4), (16, 4), (5, 64), (3, 2)):
        rows = np.arange(n_live, dtype=np.int32)
        jp = jscreened.ScreenPlan(jb, JParams(tau=0.15), 8)
        pp = screened.ScreenPlan(bank, SelectionParams(tau=0.15), 8,
                                 device="cpu")
        spans = {}
        for name, plan in (("jax", jp), ("port", pp)):
            seen = []
            orig = type(plan).screen_chunk

            def rec(self, r, c, seen=seen, orig=orig):
                seen.append(len(r))
                return orig(self, r, c)

            type(plan).screen_chunk = rec
            try:
                plan.screen_tiles(rows % 3, rows % 3, chunk=chunk)
            finally:
                type(plan).screen_chunk = orig
            spans[name] = seen
        assert spans["jax"] == spans["port"]
