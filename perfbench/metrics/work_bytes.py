"""The bytes each call's work needs: the benchmark's frozen arithmetic.

Counted from the work, not from the kernels that do it: every input byte
read once, and each register the call can reach read and written once (at
most one register an item, and at most every register there is).  So a
roofline share reads the same whatever the program runs, and no program
can move fewer bytes than it counts.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet (700 W)
REGISTER_BYTES = 1  # a register is one byte
COUNTER_BYTES = 8  # an exact count to 2^64


def stream_call(items: int, p: int) -> int:
    """One chunk into one sketch: 4 B an item, and the registers it reaches
    read and written once."""
    return 4 * items + 2 * REGISTER_BYTES * min(items, 1 << p)


def fleet_call(entries: int, rows: int, p: int) -> int:
    """One keyed tick into a bank: 8 B an entry (key and item), the registers
    it reaches and the rows' counters read and written once."""
    return 8 * entries + 2 * REGISTER_BYTES * min(entries, rows << p) + 2 * COUNTER_BYTES * rows


def call_bytes(config: dict, traffic: dict) -> int:
    """One call's bytes, by the configuration's ``system``."""
    if config["system"] == "hll_stream":
        return stream_call(int(traffic["call_items"]), int(config["p"]))
    if config["system"] == "sketch_bank":
        return fleet_call(int(traffic["call_items"]), int(config["rows"]), int(config["p"]))
    raise ValueError(f"no work bytes for system {config['system']!r}")
