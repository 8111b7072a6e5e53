"""vote_us.<part>: median device time of a count-min tick's Topkapi vote, in us.

From the traced window: the kernels, copies and fills launched inside each
``sketch.cm.vote`` span (the batch-canonical vote over the tick), by the
profiler's correlation ids.  None where no such span holds a CUDA call, as
on the CPU or in a program without the span.
"""

import statistics

from perfbench import trace as tracelib


def read(record):
    spans = tracelib.held(record.trace, "sketch.cm.vote")
    return statistics.median(s.device_s for s in spans) * 1e6 if spans else None
