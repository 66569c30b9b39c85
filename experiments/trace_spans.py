#!/usr/bin/env python3
"""Which engine span launched each device kernel of a benchmark trace.

    python3 experiments/trace_spans.py TRACE.json [--match kernelHistogram1D]

TRACE.json is a Chrome trace that `python3 -m benchmark.run --cell C
--seed S --trace-dir D` keeps (D/trace-C.json). A kernel runs after the
host has left the span that launched it, so its own time stamp does not
name the span; its `correlation` id does: the host's launch call
(category cuda_runtime or cuda_driver) carries the same id, and the
launch's time stamp lies inside one of the spans plan, schedule, prune,
screen, confirm, format. Prints one JSON line a kernel name (those that
contain --match, or every one): its launches and device milliseconds by
the span of its launch. Host only; reads the file, needs no card.
"""

import argparse
import collections
import json

SPANS = ("plan", "schedule", "prune", "screen", "confirm", "format")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def spans_of(trace, match=None):
    """{kernel name: {span: [launches, device ms]}}."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in SPANS]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}

    def span_at(t):
        inside = [name for s, e, name in spans if s <= t < e]
        return inside[-1] if inside else "between spans"

    out = collections.defaultdict(
        lambda: collections.defaultdict(lambda: [0, 0.0]))
    for e in events:
        if e.get("cat") != "kernel" or (match and match not in e["name"]):
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        slot = out[e["name"]]["no launch found" if t is None
                              else span_at(t)]
        slot[0] += 1
        slot[1] += e.get("dur", 0) / 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--match", default=None,
                    help="only kernels whose name contains this text")
    args = ap.parse_args(argv)
    with open(args.trace) as fh:
        trace = json.load(fh)
    for name, by_span in spans_of(trace, args.match).items():
        print(json.dumps({"kernel": name[:160], "spans": {
            span: {"launches": n, "device_ms": ms}
            for span, (n, ms) in by_span.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
