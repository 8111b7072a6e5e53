"""A configuration of a new system joins the benchmark by new files alone.

A copy of the benchmark gains a third system, ``twin_bank`` (the
``sketch_bank`` driver and reference under another name), with its own
configuration (cut in ``rows``), skewed traffic (hot/cold keys, as
``benchmarks/bench_sparse.py`` draws them), small sizes, test hooks, work bytes and a reader of a port
span, and with entries appended to ``BENCHMARK.json``.  No file that the
copy held before changes.  The copy's own spec, pool, control, fault and
result-line tests then run for the new cell in a subprocess.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench.tests.conftest import ROOT

CELL = "twin_fleet.skewed"
NEW_FILES = {
    "perfbench/systems/twin_bank.py": '''"""System under test ``twin_bank``: the ``sketch_bank`` driver under another name."""

from perfbench.systems.sketch_bank import call, open_state, outputs, read  # noqa: F401
''',
    "perfbench/reference/twin_bank.py": '''"""Reference of the ``twin_bank`` system: the ``sketch_bank`` reference."""

from perfbench.reference.sketch_bank import compare, expected  # noqa: F401
''',
    "perfbench/metrics/work/twin_bank.py": '''"""Work bytes of the ``twin_bank`` system: a keyed tick into a bank."""

from perfbench.metrics.work.sketch_bank import call_bytes  # noqa: F401
''',
    "perfbench/metrics/tick_us.py": '''"""tick_us.<part>: median device time of a tick, in us, from ``sketch.bank.update_many``."""

import statistics

from perfbench import trace as tracelib


def read(record):
    spans = tracelib.held(record.trace, "sketch.bank.update_many")
    return statistics.median(s.device_s for s in spans) * 1e6 if spans else None
''',
    "perfbench/tests/faults/twin_bank.py": '''"""Test hooks of the ``twin_bank`` system: those of ``sketch_bank``."""

from perfbench.tests.faults.sketch_bank import CONTROL_FAILS, faults, late_shows  # noqa: F401
''',
    "perfbench/configs/twin_fleet.json": json.dumps({
        "name": "twin_fleet", "deployment": "the tenant fleet's bank at half its rows, fed hot/cold keys",
        "source": "repo benchmarks/bench_serve.py", "system": "twin_bank", "rows": 512, "p": 12,
        "hash_bits": 64, "hash_seed": 0, "item_bits": 32, "estimator": "original", "reduced": ["rows"],
        "guarantees": ["registers exact", "each row's counter exact to 2^64"],
        "limits": {"registers_differ": 0, "counter_rows_differ": 0}}),
    "perfbench/traffic/twin_fleet.skewed.json": json.dumps({
        "pool_items": 1 << 24, "call_items": 1 << 22,
        "keys": {"dist": "hot", "frac": 0.1, "share": 0.9}}),
    "perfbench/tests/small/twin_fleet.json": json.dumps({
        "config": {"rows": 16, "p": 10}, "traffic": {"pool_items": 1 << 14, "call_items": 1 << 10}}),
}


def add_twin(root: Path) -> None:
    """Add the ``twin_bank`` system and its cell to the benchmark under ``root``."""
    for rel, text in NEW_FILES.items():
        path = root / rel
        assert not path.exists(), rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "twin_fleet", "source": "repo benchmarks/bench_serve.py",
                            "file": "perfbench/configs/twin_fleet.json", "reduced": ["rows"],
                            "why": "a second bank system"})
    spec["workloads"].append({"name": CELL, "config": "twin_fleet", "traffic": "skewed", "chips": 1,
                              "why": "a tenth of the rows take nine tenths of the entries"})
    (items_per_s,) = [m for m in spec["end_to_end"] if m["name"] == "items_per_s"]
    items_per_s["workloads"].append(CELL)
    for name, layer in (("tick_us.twin", "carrier and dispatch"), ("kernel_roofline.twin", "kernels")):
        spec["per_layer"].append({"name": name, "unit": "us" if name.startswith("tick") else "%",
                                  "better": "lower" if name.startswith("tick") else "higher",
                                  "source": "program_span", "layer": layer, "moves": "items_per_s",
                                  "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def run_tests_of_the_new_cell(root: Path) -> subprocess.CompletedProcess:
    """The copy's spec tests, and its pool, control, fault, result-line and
    import tests of the new cell, in a subprocess."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "pytest", "perfbench/tests", "-v", "-p", "no:cacheprovider", "-m", "not gpu",
         "-k", "twin or test_perfbench_spec or loads_neither"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)


def test_a_new_system_joins_by_new_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    add_twin(tmp_path)
    after = _digests(tmp_path)
    changed = {rel for rel in before if after[rel] != before[rel]}
    assert changed == {"BENCHMARK.json"} and set(after) - set(before) == set(NEW_FILES)
    out = run_tests_of_the_new_cell(tmp_path)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    tail = out.stdout.strip().splitlines()[-1]
    assert "failed" not in tail and "error" not in tail, tail
    # the new cell's own tests ran: the pool's, the control's, four faults,
    # two result lines, and the spec's
    for name in ("test_same_seed_same_pool_other_seed_other_pool[twin_fleet.skewed]",
                 "test_control_fails_and_program_passes[twin_fleet.skewed]",
                 "test_a_broken_timed_path_is_not_correct[twin_fleet.skewed-late]",
                 "test_result_line_shape[twin_fleet.skewed-True]",
                 "test_cell_finds_its_files_and_reports_enough[twin_fleet.skewed]"):
        assert f"::{name} PASSED" in out.stdout, name

