"""syncs.<part>: host synchronizes a call, in the port's spans.

From the traced window: the CUDA calls whose name holds ``Synchronize``
inside the port's spans that the harness's call and read open directly
(a dashboard's iteration is a tick and its read), summed, over the number
of calls.  None where no such span holds a CUDA call, as on the CPU.
"""

from perfbench import trace as tracelib


def read(record):
    tops = tracelib.port_tops(record.trace, (tracelib.CALL, tracelib.READ))
    calls = record.trace.spans.get(tracelib.CALL) if tops else None
    return sum(s.syncs for s in tops) / len(calls) if calls else None
