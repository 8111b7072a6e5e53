#!/usr/bin/env python3
"""The port's sketch-path spans in a benchmark cell's traced window.

    python3 tools/sketch_spans.py --workload tenant_fleet.ingest --seed 7 [--src DIR]
    python3 tools/sketch_spans.py --span-cost [--src DIR]

Run from the repo root on a machine with a CUDA card.  A workload run is
the benchmark's own traced run of the cell (``perfbench.harness.run_cell``
with tracing on, after ``SECONDS`` of untimed calls), whose traced window's
raw profiler events the tool keeps.  It prints the harness's result line
(``correct``, the cell's accepted per-layer metrics, the breakdown) with
three more keys:

* ``calls_per_s``: the traced window's calls a second;
* ``readings``: the sketch path's numbers of :func:`readings` (launches and
  host syncs a call, the exact counters' and the estimator histogram's
  device time, the estimator finalize's host time), None where the
  program has no such span, as a tree without the spans has not;
* ``split``: for each span and dispatch seam of the path, the medians of
  its host time, its waits on the card, its device time, its launches and
  its syncs.

The benchmark's own reduction of a trace counts neither launches nor syncs
a span, and reads none of the port's spans; this tool does until it does,
and then goes with its test.  Its reduction is its own: a span holds the
CUDA calls that start inside it; waiting is the whole of each synchronize
and copy, and a call's excess over the median of its name (a launch held
by a full queue); device time is found by correlation id; ``launches``
counts the CUDA calls whose correlation id has device activity (a kernel,
copy or fill), and ``syncs`` the calls whose name holds ``Synchronize``.
Host times are taken under the profiler, whose ranges add to every span
they time.

``--span-cost`` prints the host cost of the tracing calls with no profiler
recording and with one recording (ns a call, best of five rounds).
``--src DIR`` imports the program from ``DIR`` (the ``src`` of another
checkout, such as a parent commit's) in place of this tree's.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SECONDS = 2.0  # untimed calls before the traced window

WINDOW = "perfbench.window"  # the harness's mark around its traced window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("user_annotation", "cpu_op")
# the sketch path's layer spans and the dispatch seams inside them
SKETCH = ("sketch.update", "sketch.bank.update_many", "sketch.bank.counters", "sketch.bank.estimate_many",
          "sketch.estimate.histogram", "sketch.estimate.finalize")
TOP = ("sketch.update", "sketch.bank.update_many", "sketch.bank.estimate_many")  # no sketch span encloses these
CALLS = ("perfbench.call", "perfbench.read")
NAMES = CALLS + SKETCH + ("update[cuda]", "bank_update[cuda]", "estimate[original]")


@dataclass
class Span:
    """One occurrence of a span: host time, the host's waits on the card,
    the device time it launched, and its CUDA calls (all, those with
    device activity, synchronizes)."""

    wall_s: float
    wait_s: float
    device_s: float
    cuda_calls: int
    launches: int
    syncs: int


def waits(name: str) -> bool:
    """Whether a CUDA runtime or driver call named ``name`` blocks the host until the card catches up."""
    return "Synchronize" in name or name.startswith(("cudaMemcpy", "cuMemcpy"))


def correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def span_stats(events: list, names=NAMES) -> dict:
    """{name: [Span, ...]} of the ranges named in ``names`` inside the
    trace's one ``WINDOW`` range."""
    windows = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW and e.get("cat") in RANGE_CATS]
    if len(windows) != 1:
        raise ValueError(f"the trace holds {len(windows)} '{WINDOW}' annotations, not one")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device_us = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and correlation(e) is not None:
            device_us[correlation(e)] = device_us.get(correlation(e), 0.0) + float(e["dur"])
    calls = sorted((float(e["ts"]), float(e["dur"]), e["name"], correlation(e)) for e in events
                   if e.get("cat") in LAUNCH_CATS and w0 <= float(e["ts"]) <= w1)
    starts = [c[0] for c in calls]
    lengths = {}
    for _, d, name, _ in calls:
        lengths.setdefault(name, []).append(d)
    usual = {name: statistics.median(ds) for name, ds in lengths.items()}
    out = {}
    for e in events:
        if e.get("ph") != "X" or e.get("name") not in names or e.get("cat") not in RANGE_CATS:
            continue
        a0, dur = float(e["ts"]), float(e["dur"])
        if a0 < w0 or a0 + dur > w1:
            continue
        inside = calls[bisect.bisect_left(starts, a0):bisect.bisect_right(starts, a0 + dur)]
        wait = device = 0.0
        launches = syncs = 0
        for _, d, name, corr in inside:
            wait += d if waits(name) else max(0.0, d - usual[name])
            device += device_us.get(corr, 0.0)
            launches += corr in device_us
            syncs += "Synchronize" in name
        out.setdefault(e["name"], []).append(Span(dur / 1e6, wait / 1e6, device / 1e6, len(inside), launches,
                                                  syncs))
    return out


def _held(spans: dict, name: str):
    """The occurrences of ``name``, or None where there are none or none holds a CUDA call."""
    found = spans.get(name)
    if not found or not any(s.cuda_calls for s in found):
        return None
    return found


def readings(spans: dict) -> dict:
    """The sketch path's numbers from ``span_stats``: each None where its
    spans are absent or hold no CUDA call (as on the CPU)."""
    out = {}
    update = _held(spans, "sketch.update")
    out["launches.stream"] = statistics.median(s.launches for s in update) if update else None
    ticks = _held(spans, "sketch.bank.update_many")
    out["launches.fleet"] = statistics.median(s.launches for s in ticks) if ticks else None
    calls = spans.get("perfbench.call") or []
    tops = [s for name in TOP for s in (_held(spans, name) or [])]
    # host syncs a call (a dashboard's call is a tick and its read)
    out["syncs"] = sum(s.syncs for s in tops) / len(calls) if tops and calls else None
    counters = _held(spans, "sketch.bank.counters")
    out["counters_us"] = statistics.median(s.device_s for s in counters) * 1e6 if counters else None
    histogram = _held(spans, "sketch.estimate.histogram")
    out["histogram_us"] = statistics.median(s.device_s for s in histogram) * 1e6 if histogram else None
    finalize = _held(spans, "sketch.estimate.finalize")
    out["finalize_host_us"] = (statistics.median(s.wall_s - s.wait_s for s in finalize) * 1e6
                               if finalize else None)
    return out


def split(spans: dict) -> dict:
    """{name: medians of host, wait and device us, launches and syncs, and the count} of each span found."""
    out = {}
    for name, found in spans.items():
        out[name] = {
            "n": len(found),
            "host_us": statistics.median(s.wall_s for s in found) * 1e6,
            "wait_us": statistics.median(s.wait_s for s in found) * 1e6,
            "device_us": statistics.median(s.device_s for s in found) * 1e6,
            "launches": statistics.median(s.launches for s in found),
            "syncs": statistics.median(s.syncs for s in found),
        }
    return out


def run_workload(workload: str, seed: int, device) -> dict:
    """The harness's traced run of ``workload``, with the readings of its
    traced window's spans."""
    from perfbench import harness, trace

    kept, summarize = [], trace.summarize

    def keep(events):
        kept.append(events)
        return summarize(events)

    trace.summarize = keep
    try:
        result = harness.run_cell(harness.load_cell(workload), seed, SECONDS, True, device, time.perf_counter())
    finally:
        trace.summarize = summarize
    (events,) = kept
    spans = span_stats(events)
    result["workload"], result["seed"] = workload, seed
    result["calls_per_s"] = len(spans.get("perfbench.call", [])) / result["device"]["window_s"]
    result["readings"] = readings(spans)
    result["split"] = split(spans)
    return result


def _ns_per_call(fn, n: int = 200_000) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def span_cost() -> dict:
    """ns a call of the tracing calls, with no profiler and under one (host
    activity only); ``region`` is absent from a tree without it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import metrics, tracing

    def nothing():
        return None

    wrapped = metrics.wrap_backend("probe", "cost", nothing)

    def timed_span():
        with tracing.span("probe.span"):
            pass

    def seam():
        with metrics.seam("probe", "cost"):
            pass

    cases = {"call": nothing, "wrapped_backend": wrapped, "span": timed_span, "seam": seam}
    if hasattr(tracing, "region"):
        def region():
            with tracing.region("probe.region"):
                pass

        cases["region"] = region
    out = {"off": {name: _ns_per_call(fn) for name, fn in cases.items()}}
    with profile(activities=[ProfilerActivity.CPU]):
        out["on"] = {name: _ns_per_call(fn, 20_000) for name, fn in cases.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if args.span_cost:
        line = {"span_cost_ns": span_cost()}
    else:
        if not torch.cuda.is_available():
            print("sketch_spans: needs a CUDA card", file=sys.stderr)
            return 2
        line = run_workload(args.workload, args.seed, torch.device("cuda"))
    line["src"] = args.src
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
