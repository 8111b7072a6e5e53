"""Shared fixtures of the benchmark's tests.

Run from the repo root: ``python -m pytest perfbench/tests`` (CPU), and on
the card ``python -m pytest perfbench/tests -m gpu``.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

# sizes a CPU test run holds: the cells' shapes with fewer rows, a smaller
# precision and a small pool
SMALL = {
    "nic_stream": {"traffic": {"pool_items": 1 << 16, "call_items": 1 << 12}},
    "tenant_fleet": {"config": {"rows": 8, "p": 10}, "traffic": {"pool_items": 1 << 14, "call_items": 1 << 10}},
}
WORKLOADS = ("nic_stream.bulk", "tenant_fleet.ingest", "tenant_fleet.dashboard")


def small_cell(workload: str):
    from perfbench import harness

    return harness.load_cell(workload, overrides=SMALL[workload.split(".", 1)[0]])


@pytest.fixture
def card() -> torch.device:
    """The CUDA card, decided when the test runs; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with -m gpu")
    return torch.device("cuda")
