"""experiments/hostmem_split.py, the first-touch fault profile of the
host stages, rehearsed at its tiny sizes on the CPU: every stage in a
fresh interpreter with reuse off and on, outputs equal across turns, and
the checks that fail a run."""

import json
import os
import subprocess
import sys

from cuda_selection_criteria_tpu_torch.experiments import hostmem_split
from cuda_selection_criteria_tpu_torch.native import fastx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tiny_run_every_stage_off_and_on(tmp_path):
    stages = "abcd" + ("e" if fastx.available() else "")
    out = tmp_path / "split.json"
    proc = subprocess.run(
        [sys.executable, "-m", hostmem_split.__name__, "--tiny", "--device",
         "cpu", "--turns", "off,on", "--stages", stages, "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["equal"] is True
    rec = json.loads(out.read_text())
    assert rec["turns"] == ["off", "on"] and list(rec["stages"]) == \
        list(stages)
    for stage, (off, on) in rec["stages"].items():
        assert off["enabled"] is off["enabled_at_end"] is None
        assert on["enabled"] is on["enabled_at_end"] is not None
        assert off["digests"] == on["digests"] and off["digests"]
        assert not off["jax_loaded"] and not on["jax_loaded"]
        assert off["minflt"] > 0 and off["wall"] > 0
    b = rec["stages"]["b"][0]["spans"]
    for label in ("hll_a-16k", "smh_a-131k"):
        for rep in range(hostmem_split.REPS["b"]):
            for span in ("from_arrays", "select_pairs/plan",
                         "select_pairs/plan/upload_sorted_rows",
                         "select_pairs/prune", "select_pairs/screen",
                         "select_pairs/confirm", "format_results"):
                assert f"{label}/rep{rep}/{span}" in b
    stats = rec["stages"]["b"][0]["notes"]["stats"]
    assert stats["smh_a-131k/rep0"]["lines"] >= 64
    assert "confirm_secs" in stats["hll_a-16k/rep2"]
    c = rec["stages"]["c"][1]["spans"]
    assert "rep1/select_pairs/confirm/ertl_mle_batch" in c
    d = rec["stages"]["d"][0]["spans"]
    assert {"rep0/load_hll_bank p=14", "rep1/load_smh_bank m=32",
            "rep1/SketchBank.load npz"} <= set(d)
    probe = rec["stages"]["a"][1]["notes"]["probe"]
    assert sorted(probe) == ["main", "thread", "thread_small"]
    assert all(len(t) == 2 and t[0]["mb_per_s"] > 0 for t in probe.values())
    if "e" in stages:
        assert "rep1/build_bank_from_files native" in \
            rec["stages"]["e"][0]["spans"]


def test_check_records_fails_a_run():
    def rec(turn, reuse, **kw):
        return dict({"stage": "b", "turn": turn, "reuse": reuse,
                     "digests": {"x": "1"}, "enabled_at_end": None,
                     "jax_loaded": []}, **kw)

    assert hostmem_split.check_records(
        [rec(0, "off"), rec(1, "on", enabled_at_end=True)]) == []
    bad = hostmem_split.check_records(
        [rec(0, "off", enabled_at_end=True),
         rec(1, "on", digests={"x": "2"}, enabled_at_end=True),
         rec(2, "off", jax_loaded=["jax"])])
    assert len(bad) == 3
    assert "enable_arena_reuse was called" in bad[0]
    assert "outputs differ" in bad[1] and "imported" in bad[2]


def test_meter_spans_nest_and_sum():
    meter = hostmem_split.Meter()
    for _ in range(2):
        with meter.span("outer"):
            with meter.span("inner"):
                sum(range(1000))
    assert meter.spans["outer"]["calls"] == meter.spans["outer/inner"][
        "calls"] == 2
    assert meter.spans["outer"]["secs"] >= meter.spans["outer/inner"]["secs"]
