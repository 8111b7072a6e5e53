"""host_us.<part>: median host time of one call into the port, in us.

From the traced window: each call's span less the time the host spent in
it waiting for the card (synchronizes and copies to the host, and launches
held by a full queue; see ``perfbench.trace``), so that the card's work does
not read as the host's.  Taken under the profiler, which adds its own cost to every
operation it records.
"""

import statistics


def read(record):
    trace = record.trace
    calls = trace.spans.get("perfbench.call") if trace is not None else None
    if not calls:
        return None
    return statistics.median(s.wall_s - s.wait_s for s in calls) * 1e6
