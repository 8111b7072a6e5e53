"""launches.<part>: median launches of a call into the port.

From the traced window: the CUDA calls with device work (a kernel, copy or
fill) inside the port's spans that the harness's call opens directly
(``sketch.update``, ``sketch.bank.update_many``, or whatever spans a
system's entry point opens), summed over each call's spans, median over the
calls.  None where no such span holds a CUDA call, as on the CPU.
"""

import statistics

from perfbench import trace as tracelib


def read(record):
    tops = tracelib.port_tops(record.trace)
    if not tops:
        return None
    per_call = {}
    for s in tops:
        per_call[s.call] = per_call.get(s.call, 0) + s.launches
    return statistics.median(per_call.values())
