"""The bytes each call's work needs: the benchmark's frozen arithmetic.

Counted from the work, not from the kernels that do it: every input byte
read once, and each register the call can reach read and written once (at
most one register an item, and at most every register there is).  So a
roofline share reads the same whatever the program runs, and no program
can move fewer bytes than it counts.  Each system's arithmetic is in
``work/<system>.py`` (``call_bytes(config, traffic)``), which a new system
adds.
"""

from __future__ import annotations

import importlib
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet (700 W)
REGISTER_BYTES = 1  # a register is one byte
COUNTER_BYTES = 8  # an exact count to 2^64
WORK = Path(__file__).resolve().parent / "work"


def call_bytes(config: dict, traffic: dict) -> int:
    """One call's bytes, by the configuration's ``system``."""
    system = config["system"]
    if not (WORK / f"{system}.py").is_file():
        raise ValueError(f"no work bytes for system {system!r}: add {WORK / f'{system}.py'}")
    return importlib.import_module(f"perfbench.metrics.work.{system}").call_bytes(config, traffic)
