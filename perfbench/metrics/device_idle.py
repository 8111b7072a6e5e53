"""device_idle.<family>: share of the traced window with no kernel, copy or
fill on the card, in %."""


def read(record):
    trace = record.trace
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
