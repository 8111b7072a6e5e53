"""Work bytes of the ``hll_stream`` system: one chunk into one sketch."""

from perfbench.metrics.work_bytes import REGISTER_BYTES


def stream_call(items: int, p: int) -> int:
    """One chunk into one sketch: 4 B an item, and the registers it reaches
    read and written once."""
    return 4 * items + 2 * REGISTER_BYTES * min(items, 1 << p)


def call_bytes(config: dict, traffic: dict) -> int:
    return stream_call(int(traffic["call_items"]), int(config["p"]))
