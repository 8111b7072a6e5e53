"""Process-global metrics: Counter / Gauge / Histogram with a no-op default.

Port of ``repro/obs/metrics.py``, with the same names, histogram bins,
percentiles and snapshot schema.  The runtime counterpart of the paper's
resource tables (DESIGN.md §15): dispatch counts and wall time per
registry axis/backend, sparse-compaction state-machine counters,
window-cache hit rates, batch-size and latency histograms.

Everything here is host-side Python state (ints, floats, bin lists) behind
one lock; no tensor is ever stored, and no record site reads a tensor's
value (only sizes the host already knows), so recording never synchronizes
with the card.  Two invariants keep the module safe to leave compiled into
every hot seam:

* **No-op default.**  Metrics are disabled until :func:`enable` is called;
  every record site checks one module flag first, so the disabled path is
  a single attribute load + function call.
* **Trace hygiene.**  No record site runs while ``torch.compile`` traces a
  caller: :func:`recording` checks ``torch.compiler.is_compiling()``, the
  same check the window rings make before touching hidden host state.
  Tracing a compiled caller therefore neither books work the compiled
  graph replays without running Python again nor puts the registry into
  the graph.

Seam seconds are host dispatch wall time: a seam never synchronizes with
the card, so a kernel's own time is not in them unless the caller waits.
A seam reaches the metrics and the trace capture only, as the reference's
does; under ``torch.profiler`` the sketch path's own regions
(``repro_torch.obs.tracing.region``) mark each call, so a seam opens no
profiler range.
"""

from __future__ import annotations

import bisect
import functools
import json
import math
import threading
import time
from typing import Callable, Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

__all__ = [
    "enable",
    "disable",
    "enabled",
    "recording",
    "profiling",
    "inc",
    "gauge",
    "observe",
    "counter_value",
    "timed",
    "seam",
    "wrap_backend",
    "snapshot",
    "to_json",
    "reset",
]

_LOCK = threading.Lock()
_ENABLED = False

_COUNTERS: Dict[str, float] = {}
_GAUGES: Dict[str, float] = {}
_HISTS: Dict[str, "_Hist"] = {}

# Log-scaled bins shared by every histogram: 4 bins/decade from 1e-7 to
# 1e9, wide enough for sub-µs seam timings and 10^9-item batch sizes on
# the same scale.  ~65 edges -> one small int list per histogram.
_EDGES = tuple(10.0 ** (e / 4.0) for e in range(-28, 37))

# Hooks installed by repro_torch.obs.tracing at import (avoids an import cycle):
# seam timers also emit Chrome-trace events while a capture is active.
_trace_active: Callable[[], bool] = lambda: False
_trace_emit: Callable[..., None] = lambda name, t0, dur, args=None: None


def _install_trace_hook(active: Callable[[], bool], emit: Callable) -> None:
    global _trace_active, _trace_emit
    _trace_active, _trace_emit = active, emit


class _Hist:
    """Log-binned histogram: count/sum/min/max + percentile estimates."""

    __slots__ = ("count", "total", "vmin", "vmax", "bins")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.bins = [0] * (len(_EDGES) + 1)

    def add(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        self.bins[bisect.bisect_right(_EDGES, value)] += 1

    def percentile(self, q: float) -> float:
        """Bin-interpolated q-quantile (geometric midpoint within a bin)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        for i, n in enumerate(self.bins):
            acc += n
            if acc >= target and n:
                lo = _EDGES[i - 1] if i > 0 else self.vmin
                hi = _EDGES[i] if i < len(_EDGES) else self.vmax
                lo = max(min(lo, self.vmax), self.vmin)
                hi = min(max(hi, self.vmin), self.vmax)
                if lo > 0.0 and hi > 0.0:
                    return math.sqrt(lo * hi)
                return 0.5 * (lo + hi)
        return self.vmax

    def summary(self) -> dict:
        if self.count == 0:
            return {
                "count": 0,
                "sum": 0.0,
                "mean": 0.0,
                "min": 0.0,
                "max": 0.0,
                "p50": 0.0,
                "p90": 0.0,
                "p99": 0.0,
            }
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
        }


# ---------------------------------------------------------------------------
# enable / gate


def enable() -> None:
    """Turn recording on (state is kept; call :func:`reset` to clear)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def recording() -> bool:
    """True when a record site should record.

    Order matters: the module flag short-circuits first so the disabled
    path never pays the compiler check; while ``torch.compile`` traces,
    the site is skipped entirely (trace hygiene, DESIGN.md §15).
    """
    return _ENABLED and not torch.compiler.is_compiling()


def profiling() -> bool:
    """True when a span or region should also open a profiler range.

    The profiler's own module flag short-circuits first, so with no
    ``torch.profiler`` recording this is one attribute test; while
    ``torch.compile`` traces, no range is opened (trace hygiene, as
    :func:`recording`).
    """
    return _autograd_profiler._is_profiler_enabled and not torch.compiler.is_compiling()


def reset() -> None:
    """Clear every counter/gauge/histogram (enabled flag untouched)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()


# ---------------------------------------------------------------------------
# record sites


def inc(name: str, value: float = 1) -> None:
    """Add ``value`` to counter ``name`` (no-op unless :func:`recording`)."""
    if not recording():
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def gauge(name: str, value: float) -> None:
    """Set gauge ``name`` to ``value`` (last write wins)."""
    if not recording():
        return
    with _LOCK:
        _GAUGES[name] = float(value)


def observe(name: str, value: float) -> None:
    """Record ``value`` into histogram ``name``."""
    if not recording():
        return
    with _LOCK:
        hist = _HISTS.get(name)
        if hist is None:
            hist = _HISTS[name] = _Hist()
        hist.add(value)


def counter_value(name: str) -> float:
    """Current value of counter ``name`` (0 if never incremented)."""
    with _LOCK:
        return _COUNTERS.get(name, 0)


# ---------------------------------------------------------------------------
# timers


class _NullTimer:
    """Shared do-nothing context manager: the disabled fast path."""

    __slots__ = ()
    elapsed_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullTimer()


class _Timer:
    __slots__ = ("_counter", "_hist", "_trace", "_t0", "elapsed_s")

    def __init__(self, counter, hist, trace):
        self._counter = counter
        self._hist = hist
        self._trace = trace
        self.elapsed_s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        self.elapsed_s = dur
        if self._counter is not None or self._hist is not None:
            with _LOCK:
                if self._counter is not None:
                    _COUNTERS[self._counter] = _COUNTERS.get(self._counter, 0) + 1
                if self._hist is not None:
                    hist = _HISTS.get(self._hist)
                    if hist is None:
                        hist = _HISTS[self._hist] = _Hist()
                    hist.add(dur)
        if self._trace is not None:
            _trace_emit(self._trace, self._t0, dur)
        return False


def timed(name: str) -> "_Timer":
    """Context manager feeding histogram ``name`` with wall seconds."""
    if not recording():
        return _NULL
    return _Timer(None, name, None)


def seam(axis: str, backend: str) -> "_Timer":
    """Timer for one dispatch seam: ``dispatch.{axis}.{backend}``.

    Records a ``.calls`` counter and a ``.seconds`` histogram when metrics
    are enabled and a Chrome-trace event ``{axis}[{backend}]`` while a trace
    capture is active — both gated off while ``torch.compile`` traces.
    Seconds are host dispatch wall time (a kernel's first launch includes
    its build; device completion is excluded unless the caller
    synchronizes).
    """
    live_m = _ENABLED
    live_t = _trace_active()
    if not (live_m or live_t):
        return _NULL
    if torch.compiler.is_compiling():
        return _NULL
    key = f"dispatch.{axis}.{backend}"
    return _Timer(
        key + ".calls" if live_m else None,
        key + ".seconds" if live_m else None,
        f"{axis}[{backend}]" if live_t else None,
    )


def wrap_backend(axis: str, name: str, fn: Callable) -> Callable:
    """Wrap a registry backend so every real dispatch is counted + timed.

    Applied once at registration (``repro_torch.sketch.plan.register_*``), so
    the per-dispatch cost when disabled is one extra frame and two flag
    tests (metrics, the trace capture).
    Empty-stream short-circuits never reach the backend, so they are
    never counted — the spy-backend contract (tests/test_torch_obs.py).
    """

    @functools.wraps(fn)
    def dispatch(*args, **kwargs):
        if not (_ENABLED or _trace_active()):
            return fn(*args, **kwargs)
        with seam(axis, name):
            return fn(*args, **kwargs)

    dispatch.__sketch_backend__ = fn
    return dispatch


# ---------------------------------------------------------------------------
# export


def snapshot() -> dict:
    """Plain-dict snapshot of every metric (stable schema, json-ready)."""
    with _LOCK:
        return {
            "enabled": _ENABLED,
            "counters": dict(_COUNTERS),
            "gauges": dict(_GAUGES),
            "histograms": {k: h.summary() for k, h in _HISTS.items()},
        }


def to_json(indent: Optional[int] = 2) -> str:
    return json.dumps(snapshot(), indent=indent, sort_keys=True)
