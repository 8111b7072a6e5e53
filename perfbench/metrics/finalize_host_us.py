"""finalize_host_us.<part>: median host time of the estimator's finalize, in us.

From the traced window: each ``sketch.estimate.finalize`` span less the time
the host spent in it waiting for the card (see ``perfbench.trace``).  Taken
under the profiler, which adds its own cost to every operation it records.
None where no such span holds a CUDA call, as on the CPU.
"""

import statistics

from perfbench import trace as tracelib


def read(record):
    spans = tracelib.held(record.trace, "sketch.estimate.finalize")
    return statistics.median(s.wall_s - s.wait_s for s in spans) * 1e6 if spans else None
