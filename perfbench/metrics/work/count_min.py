"""Work bytes of the ``count_min`` system: one keyed tick into a count-min bank."""

from perfbench.metrics.work_bytes import COUNTER_BYTES

CELL_BYTES = 4  # a 32-bit counter, label or vote
TABLES = 3  # counters, labels, votes


def heavy_call(entries: int, rows: int, depth: int, width: int) -> int:
    """One keyed tick into a count-min bank: 8 B an entry (key and item), the
    cells it reaches in the three tables read and written once (d cells an
    entry, at most every cell there is), and the rows' counters read and
    written once."""
    cells = min(depth * entries, rows * depth * width)
    return 8 * entries + 2 * TABLES * CELL_BYTES * cells + 2 * COUNTER_BYTES * rows


def call_bytes(config: dict, traffic: dict) -> int:
    return heavy_call(int(traffic["call_items"]), int(config["rows"]), int(config["depth"]), int(config["width"]))
