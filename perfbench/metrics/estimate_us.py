"""estimate_us.<part>: median device time of one read of every estimate, in us.

From the traced window: the kernels, copies and fills that each read
(``estimate_many`` and its copy to the host) launched, by the profiler's
correlation ids; the tick's own kernels, which the read waits for, are not
counted.
"""

import statistics


def read(record):
    trace = record.trace
    reads = trace.spans.get("perfbench.read") if trace is not None else None
    if not reads or not any(s.device_s > 0 for s in reads):
        return None
    return statistics.median(s.device_s for s in reads) * 1e6
