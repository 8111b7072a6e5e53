"""BENCHMARK.json against the files it names, and the harness's lookups by name."""

import json
import re

import pytest

from perfbench import harness
from perfbench.metrics import work_bytes
from perfbench.tests.conftest import ROOT, hooks, small_path

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"] == ["python3", "-m", "perfbench.run"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("workload", CELLS)
def test_cell_finds_its_files_and_reports_enough(workload):
    cell = harness.load_cell(workload)
    system = cell.config["system"]
    assert (ROOT / "perfbench" / "systems" / f"{system}.py").is_file()
    assert (ROOT / "perfbench" / "reference" / f"{system}.py").is_file()
    assert small_path(workload).is_file()
    assert (ROOT / "perfbench" / "tests" / "faults" / f"{system}.py").is_file()
    assert {"faults", "CONTROL_FAILS", "late_shows"} <= set(vars(hooks(system)))
    if cell.traffic.get("read_each_call"):
        assert {"altered_read", "altered_read_shows"} <= set(vars(hooks(system)))
    if any(m["name"].startswith("kernel_roofline.") for m in cell.per_layer):
        assert work_bytes.call_bytes(cell.config, cell.traffic) > 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))


def test_every_metric_lists_cells_that_report_what_it_moves():
    for m in SPEC["per_layer"]:
        for w in m["workloads"]:
            assert w in CELLS
            assert m["name"] in {x["name"] for x in harness.load_cell(w).per_layer}


def test_metric_reader_is_found_by_its_family():
    assert harness.metric_path("host_us.stream").name == "host_us.py"
    assert harness.metric_path("kernel_roofline.fleet").name == "kernel_roofline.py"
    assert harness.metric_path("kernel_roofline.stream").name == "kernel_roofline.py"
    with pytest.raises(FileNotFoundError):
        harness.metric_path("no_such_metric.x")


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("nic_stream.nothing")


def test_configs_state_guarantees_and_limits():
    for c in SPEC["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"]
        assert all(key in config for key in c["reduced"])
        assert config["guarantees"] and config["limits"] and config["source"]
