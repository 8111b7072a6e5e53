"""The traced window: torch.profiler over a stretch of calls, reduced to numbers.

``profiled`` runs a loop under ``torch.profiler`` (host and card
activities) inside a ``perfbench.window`` annotation that ends with a
synchronize, writes the Chrome trace to a temporary file, reads it back and
deletes it.  ``summarize`` reduces the trace to

* ``busy_s``: the union of the card's kernels, copies and fills inside the
  window, in seconds;
* ``window_s``: the window's length on the same clock;
* ``device_ops``: the ten device operations that took most time, by name;
* ``idle_gaps``: the gaps in the card's timeline, each named by the
  innermost host operation running at its midpoint ("python_between_calls"
  where there is none), summed by name, the ten largest;
* ``spans``: for each range in the window whose name starts with one of
  ``SPAN_PREFIXES`` (the harness's marks around each call and read, and the
  port's own spans, ``sketch.*``), one ``Span`` an occurrence: its length
  on the host, the part of it the host spent waiting for the card, the
  device time of the kernels, copies and fills launched inside it, found by
  the profiler's correlation ids, its CUDA calls, its launches (the CUDA
  calls whose correlation id has device work) and its syncs (the calls
  whose name holds ``Synchronize``), the name of the innermost such range
  that encloses it, and the index of the harness's call that encloses it.  Waiting is the whole of each synchronize and
  copy, and the part of any other CUDA call beyond the median length of
  calls of its name in the window: a launch that finds the card's queue
  full blocks until a slot frees, which is the card's pace, not the host's.

A per-layer reader reads a span by its name (``held``), or the port's spans
that the harness's call or read opens directly (``port_tops``), so that a
new span of the port is read by a new reader alone.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"
TOP = 10
NAME_CHARS = 96
SCAN = 512
SPAN_PREFIXES = ("perfbench.", "sketch.")
CALL, READ = "perfbench.call", "perfbench.read"
PORT = "sketch."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Span:
    wall_s: float
    wait_s: float
    device_s: float
    launches: int = 0
    syncs: int = 0
    cuda_calls: int = 0
    parent: str = ""
    call: int = -1  # which ``perfbench.call`` of the window encloses it, in order; -1 where none


@dataclass
class Trace:
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list
    spans: dict = field(default_factory=dict)


def _waits(name: str) -> bool:
    """Whether a CUDA runtime or driver call named ``name`` blocks the host until the card catches up."""
    return "Synchronize" in name or name.startswith(("cudaMemcpy", "cuMemcpy"))


def profiled(loop, device) -> Trace:
    """The Trace of ``loop()`` run under the profiler, which records the
    card's activity where ``device`` is a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            loop()
            if on_card:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events)


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _top(totals: dict) -> list:
    return [[name, seconds] for name, seconds in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(events: list) -> Trace:
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in spans if e["name"] == WINDOW and e.get("cat") in ("user_annotation", "cpu_op")]
    if len(windows) != 1:
        raise ValueError(f"the trace holds {len(windows)} '{WINDOW}' annotations, not one")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device, op_totals = [], {}
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        start, end = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if end <= start:
            continue
        device.append((start, end))
        name = e["name"][:NAME_CHARS]
        op_totals[name] = op_totals.get(name, 0.0) + (end - start) / 1e6
    busy = _merge(device)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in spans
                  if e.get("cat") in HOST_CATS and e["name"] != WINDOW)
    starts = [h[0] for h in host]
    gaps, edges = {}, [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        name = "python_between_calls"
        # the innermost host operation running at the gap's midpoint: the
        # latest-starting one that has not yet ended, looked for among the
        # SCAN operations that started last (a call is a few dozen)
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - SCAN, -1), -1):
            if host[i][1] >= mid:
                name = host[i][2][:NAME_CHARS]
                break
        key = "host:" + name
        gaps[key] = gaps.get(key, 0.0) + (g1 - g0) / 1e6
    return Trace(
        busy_s=sum(end - start for start, end in busy) / 1e6,
        window_s=(w1 - w0) / 1e6,
        device_ops=_top(op_totals),
        idle_gaps=_top(gaps),
        spans=_spans(spans, w0, w1),
    )


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def _spans(events: list, w0: float, w1: float) -> dict:
    """{name: [Span, ...]} of the ranges named with a prefix of ``SPAN_PREFIXES`` inside the window."""
    device_us = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and _correlation(e) is not None:
            device_us[_correlation(e)] = device_us.get(_correlation(e), 0.0) + float(e["dur"])
    launches = sorted((float(e["ts"]), float(e["dur"]), e["name"], _correlation(e)) for e in events
                      if e.get("cat") in LAUNCH_CATS and w0 <= float(e["ts"]) <= w1)
    starts = [x[0] for x in launches]
    lengths = {}
    for _, d, name, _ in launches:
        lengths.setdefault(name, []).append(d)
    usual = {name: statistics.median(ds) for name, ds in lengths.items()}
    ranges = sorted(((float(e["ts"]), -float(e["dur"]), e["name"]) for e in events
                     if e.get("cat") in ("user_annotation", "cpu_op") and e["name"] != WINDOW
                     and e["name"].startswith(SPAN_PREFIXES)
                     and w0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= w1))
    out, open_ranges, calls = {}, [], 0
    for a0, neg_dur, name in ranges:
        a1 = a0 - neg_dur
        while open_ranges and open_ranges[-1][0] < a1:
            open_ranges.pop()
        parent, call_index = open_ranges[-1][1:] if open_ranges else ("", -1)
        if name == CALL:
            call_index, calls = calls, calls + 1
        open_ranges.append((a1, name, call_index))
        inside = launches[bisect.bisect_left(starts, a0):bisect.bisect_right(starts, a1)]
        wait = device = 0.0
        n_launches = n_syncs = 0
        for _, d, call, corr in inside:
            wait += d if _waits(call) else max(0.0, d - usual[call])
            device += device_us.get(corr, 0.0)
            n_launches += corr in device_us
            n_syncs += "Synchronize" in call
        out.setdefault(name, []).append(Span(-neg_dur / 1e6, wait / 1e6, device / 1e6, n_launches, n_syncs,
                                             len(inside), parent, call_index))
    return out


def held(trace, name: str):
    """The occurrences of span ``name`` in ``trace``, or None where there are
    none or none holds a CUDA call (as on the CPU)."""
    found = trace.spans.get(name) if trace is not None else None
    if not found or not any(s.cuda_calls for s in found):
        return None
    return found


def port_tops(trace, parents=(CALL,)):
    """The port's spans that a range named in ``parents`` opens directly (a
    call's ``sketch.update`` or ``sketch.bank.update_many``), or None where
    there are none or none holds a CUDA call."""
    if trace is None:
        return None
    found = [s for name, spans in trace.spans.items() if name.startswith(PORT)
             for s in spans if s.parent in parents]
    if not any(s.cuda_calls for s in found):
        return None
    return found
