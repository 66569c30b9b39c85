"""experiments/trace_spans.py: a device kernel is charged to the span in
which the host launched it (matched by correlation id), not to the span
its own time stamp falls in."""

import importlib.util
import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _load():
    spec = importlib.util.spec_from_file_location(
        "trace_spans", os.path.join(HERE, "..", "experiments",
                                    "trace_spans.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


TRACE = {"traceEvents": [
    _ev("user_annotation", "plan", 0, 100),
    _ev("user_annotation", "prune", 100, 100),
    # launched in the plan, run during the prune
    _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, 1),
    _ev("kernel", "kernelHistogram1D<long>", 150, 4000, 1),
    _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, 2),
    _ev("kernel", "kernelHistogram1D<long>", 300, 1000, 2),
    _ev("cuda_driver", "cuLaunchKernel", 120, 1, 3),
    _ev("kernel", "gate_counts_kernel<8>", 400, 2500, 3),
    _ev("kernel", "orphan", 500, 10, 9),
    _ev("cpu_op", "aten::bincount", 10, 5),
]}


def test_kernels_charged_to_their_launch_span():
    spans = _load().spans_of(TRACE)
    assert spans["kernelHistogram1D<long>"] == {"plan": [2, 5.0]}
    assert spans["gate_counts_kernel<8>"] == {"prune": [1, 2.5]}
    assert spans["orphan"] == {"no launch found": [1, 0.01]}


@pytest.mark.parametrize("match,names", [
    ("Histogram", ["kernelHistogram1D<long>"]),
    (None, ["kernelHistogram1D<long>", "gate_counts_kernel<8>", "orphan"]),
])
def test_cli_prints_one_line_a_kernel(tmp_path, capsys, match, names):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    argv = [str(path)] + (["--match", match] if match else [])
    assert _load().main(argv) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["kernel"] for x in lines] == names
    assert lines[0]["spans"]["plan"] == {"launches": 2, "device_ms": 5.0}
