"""repro_torch.obs — runtime observability: metrics registry + span tracing.

Port of ``repro.obs`` (DESIGN.md §15).  ``metrics`` holds the
process-global Counter/Gauge/Histogram registry (a no-op until
``metrics.enable()``); ``tracing`` provides the ``span()`` context manager
and Chrome-trace capture (``start_trace()`` → ``write_trace(path)`` → load
in Perfetto); ``format`` is the shared report-line vocabulary.

Importing this package wires the tracing hook into the metrics seam
timers, so dispatch seams appear in trace captures automatically.
"""

from repro_torch.obs import format, metrics, tracing

__all__ = ["format", "metrics", "tracing"]
