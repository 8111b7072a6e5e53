"""Work bytes of the ``sketch_bank`` system: one keyed tick into a bank."""

from perfbench.metrics.work_bytes import COUNTER_BYTES, REGISTER_BYTES


def fleet_call(entries: int, rows: int, p: int) -> int:
    """One keyed tick into a bank: 8 B an entry (key and item), the registers
    it reaches and the rows' counters read and written once."""
    return 8 * entries + 2 * REGISTER_BYTES * min(entries, rows << p) + 2 * COUNTER_BYTES * rows


def call_bytes(config: dict, traffic: dict) -> int:
    return fleet_call(int(traffic["call_items"]), int(config["rows"]), int(config["p"]))
