"""counters_us.<part>: median device time of a tick's exact row counters, in us.

From the traced window: the kernels, copies and fills launched inside each
``sketch.bank.counters`` span (``bank_row_count``), by the profiler's
correlation ids.  None where no such span holds a CUDA call, as on the CPU.
"""

import statistics

from perfbench import trace as tracelib


def read(record):
    spans = tracelib.held(record.trace, "sketch.bank.counters")
    return statistics.median(s.device_s for s in spans) * 1e6 if spans else None
