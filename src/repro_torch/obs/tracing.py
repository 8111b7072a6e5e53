"""Nested span tracing → Chrome-trace-event JSON, plus shared timer helpers.

``span("name")`` is the one timing idiom for launch/train/bench code
(replacing the hand-rolled ``perf_counter`` pairs): it always measures
``elapsed_s``; while a capture started by :func:`start_trace` is active it
also appends a Chrome ``"X"`` (complete) event, and ``metric=`` feeds the
duration into a metrics histogram when metrics are enabled.  Nesting needs
no bookkeeping — Perfetto reconstructs the stack from overlapping
``ts``/``dur`` ranges per thread.

:func:`chrome_trace` / :func:`write_trace` emit the ``{"traceEvents":
[...]}`` JSON that Perfetto (https://ui.perfetto.dev) and
``chrome://tracing`` load directly.  The event buffer is host-side only;
span bodies that run while ``torch.compile`` traces record nothing (same
hygiene gate as the metrics registry, DESIGN.md §15).  Port of
``repro/obs/tracing.py`` with the same event fields.

A span's ``elapsed_s`` and its capture event are host wall time
(``perf_counter``).  While ``torch.profiler`` records, a span also opens a
``record_function`` range of its name: the range lands in the profiler's
trace as a ``user_annotation`` on the device trace's clock, and the
profiler's correlation ids tie each launch inside it to the card's
kernels, copies and fills, so a profile reads the span's device time and
its waits on the card.  A dispatch seam opens no range: it reaches the
metrics and the capture only.  :func:`region` is that range alone, for
the sketch path's layer boundaries (``sketch.update``,
``sketch.bank.update_many``, ``sketch.bank.counters``,
``sketch.bank.estimate_many``, ``sketch.estimate.histogram``,
``sketch.estimate.finalize``, and the count-min tick's
``sketch.cm.update_many``, ``sketch.cm.scatter``, ``sketch.cm.vote``,
``sketch.cm.counters``): it costs one flag test with no profiler
recording and adds no event to the capture, which keeps the reference's
events.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import torch

from repro_torch.obs import metrics as _metrics

__all__ = [
    "span",
    "region",
    "Stopwatch",
    "start_trace",
    "stop_trace",
    "active",
    "chrome_trace",
    "write_trace",
]

_LOCK = threading.Lock()
_EVENTS: list = []
_ACTIVE = False
_T0 = 0.0


def start_trace() -> None:
    """Begin a capture: clears the buffer and timestamps events from now."""
    global _ACTIVE, _T0
    with _LOCK:
        _EVENTS.clear()
        _T0 = time.perf_counter()
        _ACTIVE = True


def stop_trace() -> list:
    """End the capture; returns the buffered events (buffer is kept)."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = False
        return list(_EVENTS)


def active() -> bool:
    return _ACTIVE


def _emit(name: str, t0: float, dur_s: float, args: Optional[dict] = None):
    if not _ACTIVE or torch.compiler.is_compiling():
        return
    event = {
        "name": name,
        "ph": "X",
        "ts": (t0 - _T0) * 1e6,
        "dur": dur_s * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if args:
        event["args"] = {k: str(v) for k, v in args.items()}
    with _LOCK:
        if _ACTIVE:
            _EVENTS.append(event)


# dispatch-seam timers (metrics.seam / wrap_backend) emit through us too,
# so a --trace capture shows backend dispatches under the outer spans
_metrics._install_trace_hook(active, _emit)


class span:
    """Context-manager timer; emits a Chrome event while a trace is active.

    ``with span("prefill") as t: ...`` then read ``t.elapsed_s``.  Pass
    ``metric="serve.request.seconds"`` to also feed a metrics histogram
    (no-op unless metrics are enabled); extra keyword arguments land in
    the event's ``args`` payload.  While ``torch.profiler`` records, the
    body also runs inside a profiler range ``name`` (outside the timing).
    """

    __slots__ = ("name", "metric", "args", "elapsed_s", "_t0", "_range")

    def __init__(self, name: str, *, metric: Optional[str] = None, **args):
        self.name = name
        self.metric = metric
        self.args = args or None
        self.elapsed_s = 0.0

    def __enter__(self) -> "span":
        self._range = _metrics.record_function(self.name) if _metrics.profiling() else None
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.elapsed_s = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        _emit(self.name, self._t0, self.elapsed_s, self.args)
        if self.metric is not None:
            _metrics.observe(self.metric, self.elapsed_s)
        return False


# region's do-nothing context: a nullcontext, which torch.compile enters
# without breaking the graph
_OFF = contextlib.nullcontext()


def region(name: str):
    """A profiler range ``name`` around a ``with`` body while
    ``torch.profiler`` records (not while ``torch.compile`` traces), else
    a shared do-nothing context: a span that reaches the profiler only,
    with no ``elapsed_s`` and no capture event."""
    if _metrics.profiling():
        return _metrics.record_function(name)
    return _OFF


class Stopwatch:
    """Explicit ``start()``/``stop()`` timer for split begin/end seams.

    The watchdog-style idiom where begin and end live in different calls
    (so a context manager cannot span them).  ``stop()`` returns elapsed
    seconds and disarms; ``elapsed()`` peeks without disarming.
    """

    __slots__ = ("_t0",)

    def __init__(self):
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self._t0 is not None

    def elapsed(self) -> float:
        assert self._t0 is not None, "start() not called"
        return time.perf_counter() - self._t0

    def stop(self) -> float:
        dt = self.elapsed()
        self._t0 = None
        return dt


def chrome_trace() -> dict:
    """The capture as a Chrome-trace dict (Perfetto-loadable as JSON)."""
    with _LOCK:
        events = list(_EVENTS)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
    return path
