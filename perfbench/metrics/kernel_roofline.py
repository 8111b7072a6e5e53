"""kernel_roofline.<part>: the calls' work bytes at the HBM peak over the
device time the calls launched, in %.

The bytes are the work's (``work_bytes``, by the configuration's
``system``), not those of the kernels that do it; the time is every
kernel, copy and fill launched inside the traced calls, whatever it is
named.
"""

from perfbench.metrics import work_bytes


def read(record):
    trace = record.trace
    calls = trace.spans.get("perfbench.call") if trace is not None else None
    device_s = sum(s.device_s for s in calls) if calls else 0.0
    if device_s <= 0:
        return None
    per_call = work_bytes.call_bytes(record.config, record.traffic)
    return 100.0 * len(calls) * per_call / work_bytes.HBM_BYTES_PER_S / device_s
