"""One formatting vocabulary for launch report lines (DESIGN.md §15).

A copy of ``repro/obs/format.py``: the port keeps its own, so that it
imports nothing of the reference.  Every helper returns the same string
for the same value.

serve.py's board/bank/heavy/window report lines used to print raw floats
with whatever precision each f-string happened to pick, and truncated
top-k listings with an unlabeled ``...`` row.  Every human-facing number
now routes through these helpers — the same ones the periodic
``[metrics]`` report line uses — so precision and labels stay consistent
across surfaces.  Pure string munging: no torch, no metrics state.
"""

from __future__ import annotations

import math

__all__ = [
    "fmt_count",
    "fmt_float",
    "fmt_pct",
    "fmt_seconds",
    "fmt_rate",
    "fmt_bytes",
    "per_second",
    "kv_line",
    "truncated_note",
    "metrics_report_line",
]


def fmt_count(x: float) -> str:
    """Integer quantities: thousands separators, no decimals.

    Non-finite values render as ``inf``/``-inf``/``nan`` instead of
    raising from ``round()`` — a zero-elapsed throughput on a fast
    machine must degrade a report line, never crash the launcher.
    """
    x = float(x)
    if not math.isfinite(x):
        return str(x)
    return f"{round(x):,}"


def per_second(count: float, elapsed_s: float) -> float:
    """A rate that tolerates zero/near-zero timer spans.

    ``span``/``Stopwatch`` measure with ``perf_counter``, whose
    resolution can quantize a tiny timed region to exactly 0.0 — the
    naive ``count / elapsed`` then dies with ZeroDivisionError.  Zero
    work in zero time is 0.0; finite work in zero time is ``inf``,
    which every ``fmt_*`` helper renders safely.
    """
    count = float(count)
    elapsed_s = float(elapsed_s)
    if elapsed_s <= 0.0:
        return 0.0 if count == 0.0 else math.inf
    return count / elapsed_s


def fmt_float(x: float, digits: int = 1) -> str:
    return f"{float(x):.{digits}f}"


def fmt_pct(x: float, digits: int = 1) -> str:
    """A 0..1 ratio as a percentage."""
    return f"{float(x):.{digits}%}"


def fmt_seconds(s: float) -> str:
    """Auto-scaled wall time: 12µs / 3.4ms / 1.2s."""
    s = float(s)
    if s < 1e-3:
        return f"{s * 1e6:.0f}µs"
    if s < 1.0:
        return f"{s * 1e3:.1f}ms"
    return f"{s:.2f}s"


def fmt_rate(x: float, unit: str) -> str:
    """Throughput: '12,345 tok/s'."""
    return f"{fmt_count(x)} {unit}/s"


def fmt_bytes(n: float) -> str:
    n = float(n)
    for scale, suffix in ((1 << 30, "GiB"), (1 << 20, "MiB"), (1 << 10, "KiB")):
        if n >= scale:
            return f"{n / scale:.1f}{suffix}"
    return f"{fmt_count(n)}B"


def kv_line(label: str, pairs, indent: str = "  ") -> str:
    """'  label: k=v k=v' — the shared report-line shape."""
    body = " ".join(f"{k}={v}" for k, v in pairs)
    return f"{indent}{label}: {body}"


def truncated_note(shown: int, total: int, noun: str, indent: str = "    "):
    """Labeled truncation row: '    ... +4 more requests (of 8 total)'."""
    return f"{indent}... +{total - shown} more {noun} (of {total} total)"


def metrics_report_line(snap: dict) -> str:
    """One-line digest of a metrics snapshot for periodic serve reports."""
    counters = snap.get("counters", {})
    hists = snap.get("histograms", {})
    parts = []
    req = hists.get("serve.request.seconds")
    if req and req["count"]:
        p50, p99 = fmt_seconds(req["p50"]), fmt_seconds(req["p99"])
        parts.append(f"req p50={p50} p99={p99}")
    dispatches = sum(
        v
        for k, v in counters.items()
        if k.startswith("dispatch.") and k.endswith(".calls")
    )
    parts.append(f"dispatches={fmt_count(dispatches)}")
    compactions = counters.get("sparse.flush.pressure", 0) + counters.get(
        "sparse.flush.read", 0
    )
    parts.append(f"compactions={fmt_count(compactions)}")
    hits = counters.get("window.fold_cache.hits", 0)
    misses = counters.get("window.fold_cache.misses", 0)
    if hits + misses:
        parts.append(f"window-cache hit={fmt_pct(hits / (hits + misses))}")
    return "[metrics] " + " ".join(parts)
