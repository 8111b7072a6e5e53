"""Shared fixtures of the benchmark's tests.

Run from the repo root: ``python -m pytest perfbench/tests`` (CPU), and on
the card ``python -m pytest perfbench/tests -m gpu``.

Everything about a cell is found by name: the cells are ``BENCHMARK.json``'s;
a configuration's small CPU sizes are ``small/<config>.json`` (``{"config":
{...}, "traffic": {...}}``: the keys that replace the files'), and a
system's test hooks are ``faults/<system>.py`` (see ``faults/__init__.py``).
"""

import importlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

TESTS = Path(__file__).resolve().parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = tuple(w["name"] for w in SPEC["workloads"])


def small_path(workload: str) -> Path:
    """The small sizes of ``workload``'s configuration: ``small/<config>.json``."""
    (cell,) = [w for w in SPEC["workloads"] if w["name"] == workload]
    return TESTS / "small" / f"{cell['config']}.json"


def small_cell(workload: str):
    """``workload`` at the sizes a CPU test run holds: the cell's shapes with
    fewer rows, a smaller precision and a small pool."""
    from perfbench import harness

    return harness.load_cell(workload, overrides=json.loads(small_path(workload).read_text()))


def hooks(system: str):
    """The test hooks of ``system``: ``faults/<system>.py``."""
    return importlib.import_module(f"perfbench.tests.faults.{system}")


@pytest.fixture
def card() -> torch.device:
    """The CUDA card, decided when the test runs; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with -m gpu")
    return torch.device("cuda")
