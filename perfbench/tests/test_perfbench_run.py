"""A run's result line, the refusals of run.py, the import check and the trace reduction."""

import ast
import json
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness, trace
from perfbench.metrics import work_bytes
from perfbench.tests.conftest import ROOT, SPEC, WORKLOADS, small_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("tracing", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line_shape(workload, tracing):
    cell = small_cell(workload)
    result = harness.run_cell(cell, 2**31 + 3, 0.05, tracing, CPU, 0.0)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, check in line["checks"].items():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"]
    want = {m["name"] for m in (cell.per_layer if tracing else cell.end_to_end)}
    if tracing:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert len(line["breakdown"]["device_ops"]) <= 10 and len(line["breakdown"]["idle_gaps"]) <= 10
        # on the CPU no device operation runs, so only host spans read
        assert set(line["metrics"]) <= want
    else:
        assert set(line["metrics"]) == want
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"} and metric["value"] > 0
    assert harness.check_lines(result)[0].startswith("check ")


def _run_py(cwd, *extra):
    return subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "nic_stream.bulk",
                           "--seed", "1", "--seconds", "1", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_run_py_prints_nothing_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_run_py_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch", "repro_torch.sketch", "reproduce", "jax_like", "numpy",
             "repro", "repro.sketch.hll", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert harness.forbidden_modules(names) == sorted(
        ["repro", "repro.sketch.hll", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"])


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    systems = sorted({json.loads((ROOT / c["file"]).read_text())["system"] for c in SPEC["configs"]})
    readers = [m["name"] for m in SPEC["per_layer"]]
    code = ("import importlib, sys; sys.path[:0] = ['src', '.']\n"
            "from perfbench import harness, calibrate, run\n"
            f"for s in {systems!r}:\n"
            "    importlib.import_module('perfbench.systems.' + s)\n"
            "    importlib.import_module('perfbench.reference.' + s)\n"
            f"for m in {readers!r}: harness.metric_reader(m)\n"
            "print(harness.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro", "jax", "jaxlib", "flax"), (path, name)


def test_work_bytes_are_pinned():
    from perfbench.metrics.work.hll_stream import stream_call
    from perfbench.metrics.work.sketch_bank import fleet_call

    # a 2^20-item chunk into 2^16 registers
    assert stream_call(1 << 20, 16) == 4_325_376
    # a 2^14-entry tick into a (1024, 2^12) bank with 1024 counters
    assert fleet_call(1 << 14, 1024, 12) == 180_224
    # each cell's call, by its system
    # nic_stream.bulk: a 2^26-item chunk; tenant_fleet: a 2^25-entry tick, which reaches every register
    assert stream_call(1 << 26, 16) == 268_566_528
    assert fleet_call(1 << 25, 1024, 12) == 276_840_448
    for workload, want in (("nic_stream.bulk", 268_566_528), ("tenant_fleet.ingest", 276_840_448),
                           ("tenant_fleet.dashboard", 276_840_448)):
        cell = harness.load_cell(workload)
        assert work_bytes.call_bytes(cell.config, cell.traffic) == want
    with pytest.raises(ValueError, match="no work bytes"):
        work_bytes.call_bytes({"system": "no_such_system"}, {"call_items": 1})


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_summary_unions_device_time_and_names_gaps():
    events = [
        _x("user_annotation", trace.WINDOW, 0.0, 100.0),
        _x("user_annotation", "perfbench.call", 0.0, 30.0),
        _x("cpu_op", "aten::add", 32.0, 6.0),
        _x("kernel", "k1", 10.0, 20.0),
        _x("kernel", "k2", 25.0, 10.0),   # overlaps k1: counted once
        _x("gpu_memcpy", "copy", 50.0, 10.0),
        _x("kernel", "late", 95.0, 20.0),  # clipped at the window's end
        _x("gpu_user_annotation", trace.WINDOW, 0.0, 100.0),
    ]
    t = trace.summarize(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((25 + 10 + 5) * 1e-6)
    assert dict(t.device_ops)["k1"] == pytest.approx(20e-6)
    gaps = dict(t.idle_gaps)
    # gaps: [0,10) mid 5 in perfbench.call; [35,50) mid 42.5 none; [60,95) mid 77.5 none
    assert gaps["host:perfbench.call"] == pytest.approx(10e-6)
    assert gaps["host:python_between_calls"] == pytest.approx(50e-6)


def _traced_calls():
    """Two calls: the first launches two kernels, the second a kernel and a
    copy to the host that waits for it; a read launches one kernel."""
    return [
        _x("user_annotation", trace.WINDOW, 0.0, 200.0),
        _x("user_annotation", "perfbench.call", 0.0, 20.0),
        _x("cuda_runtime", "cudaLaunchKernel", 2.0, 2.0, corr=1),
        _x("cuda_driver", "cuLaunchKernel", 8.0, 3.0, corr=2),
        _x("kernel", "hash", 6.0, 10.0, corr=1),
        _x("kernel", "scatter", 16.0, 30.0, corr=2),
        _x("user_annotation", "perfbench.call", 30.0, 60.0),
        _x("cuda_runtime", "cudaLaunchKernel", 31.0, 2.0, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 34.0, 50.0, corr=4),
        _x("kernel", "bincount", 46.0, 30.0, corr=3),
        _x("gpu_memcpy", "Memcpy DtoH", 80.0, 2.0, corr=4),
        _x("user_annotation", "perfbench.read", 100.0, 40.0),
        _x("cuda_runtime", "cudaLaunchKernel", 101.0, 2.0, corr=5),
        _x("cuda_runtime", "cudaStreamSynchronize", 104.0, 30.0),
        _x("kernel", "histogram", 105.0, 25.0, corr=5),
    ]


def test_trace_spans_split_host_waits_and_device_time():
    t = trace.summarize(_traced_calls())
    calls, (read,) = t.spans["perfbench.call"], t.spans["perfbench.read"]
    assert [(s.wall_s, s.wait_s) for s in calls] == [(20e-6, 0.0), (60e-6, 50e-6)]
    assert [s.device_s for s in calls] == [pytest.approx(40e-6), pytest.approx(32e-6)]
    assert (read.wall_s, read.wait_s) == (40e-6, 30e-6) and read.device_s == pytest.approx(25e-6)


def test_a_launch_held_by_a_full_queue_is_waiting():
    events = [
        _x("user_annotation", trace.WINDOW, 0.0, 2000.0),
        *[_x("user_annotation", "perfbench.call", 100.0 * i, 90.0) for i in range(4)],
        *[_x("cuda_runtime", "cudaLaunchKernel", 100.0 * i + 1, 4.0, corr=i) for i in range(4)],
        # the fourth call's second launch blocks 60 us on a full queue
        _x("cuda_runtime", "cudaLaunchKernel", 310.0, 64.0, corr=9),
    ]
    calls = trace.summarize(events).spans["perfbench.call"]
    assert [s.wait_s for s in calls] == [0.0, 0.0, 0.0, pytest.approx(60e-6)]


def test_readers_return_nothing_where_nothing_is_read():
    config, traffic = {"system": "hll_stream", "p": 16}, {"call_items": 1 << 20}
    rec = harness.Record(config, traffic, None)
    for name in ("host_us.stream", "kernel_roofline.stream", "kernel_roofline.fleet", "device_idle.stream",
                 "estimate_us.dashboard"):
        assert harness.metric_reader(name)(rec) is None
    rec.trace = trace.Trace(busy_s=0.5, window_s=1.0, device_ops=[], idle_gaps=[])
    assert harness.metric_reader("device_idle.stream")(rec) == pytest.approx(50.0)
    assert harness.metric_reader("kernel_roofline.stream")(rec) is None
    rec.trace = trace.summarize(_traced_calls())
    # host: 20 us and 60 - 50 us; device: 40 us and 32 us over two calls
    assert harness.metric_reader("host_us.stream")(rec) == pytest.approx(15.0)
    share = harness.metric_reader("kernel_roofline.stream")(rec)
    assert share == pytest.approx(100 * 2 * 4_325_376 / 3.35e12 / 72e-6)
    assert harness.metric_reader("estimate_us.dashboard")(rec) == pytest.approx(25.0)
    fleet = harness.Record({"system": "sketch_bank", "p": 12, "rows": 1024}, {"call_items": 1 << 14}, rec.trace)
    assert harness.metric_reader("kernel_roofline.fleet")(fleet) == pytest.approx(100 * 2 * 180_224 / 3.35e12 / 72e-6)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_a_reader_reads_nothing_without_a_trace(metric):
    (entry,) = [m for m in SPEC["per_layer"] if m["name"] == metric]
    loaded = small_cell(entry["workloads"][0])
    assert harness.metric_reader(metric)(harness.Record(loaded.config, loaded.traffic, None)) is None


def _dashboard_iteration():
    """One tick (its scatter, then the counters with a copy to the host and a
    synchronize, and a histogram), and one read (the histogram with its own
    sync, then a finalize of two small kernels), then the read's copy of the
    estimates; the port's seams (``bank_update[cuda]``, ``estimate[original]``)
    lie between its spans."""
    note = lambda name, t0, t1: _x("user_annotation", name, t0, t1 - t0)
    launch = lambda ts, corr, name="cudaLaunchKernel", dur=5.0: _x("cuda_runtime", name, ts, dur, corr)
    return [
        note(trace.WINDOW, 0.0, 1000.0),
        note("perfbench.call", 0.0, 300.0),
        note("sketch.bank.update_many", 10.0, 290.0),
        note("bank_update[cuda]", 20.0, 100.0),
        launch(30.0, 1), _x("kernel", "hash_rank_kernel", 40.0, 50.0, 1),
        launch(60.0, 2), _x("kernel", "bank_scatter_kernel", 90.0, 100.0, 2),
        note("sketch.bank.counters", 110.0, 280.0),
        launch(120.0, 3), _x("kernel", "where", 190.0, 20.0, 3),
        launch(130.0, 4, "cudaMemcpyAsync", 80.0), _x("gpu_memcpy", "Memcpy DtoH", 210.0, 2.0, 4),
        _x("cuda_runtime", "cudaStreamSynchronize", 215.0, 5.0),
        launch(230.0, 5), _x("kernel", "kernelHistogram1D", 240.0, 30.0, 5),
        _x("cuda_runtime", "cudaGetDevice", 250.0, 1.0, 6),  # a CUDA call with no device work
        note("perfbench.read", 400.0, 700.0),
        note("sketch.bank.estimate_many", 405.0, 650.0),
        note("estimate[original]", 410.0, 640.0),
        note("sketch.estimate.histogram", 415.0, 520.0),
        launch(420.0, 7), _x("kernel", "kernelHistogram1D", 430.0, 60.0, 7),
        launch(440.0, 8, "cudaMemcpyAsync", 52.0), _x("gpu_memcpy", "Memcpy DtoH", 490.0, 1.0, 8),
        _x("cuda_runtime", "cudaStreamSynchronize", 495.0, 3.0),
        note("sketch.estimate.finalize", 530.0, 630.0),
        launch(540.0, 9), _x("kernel", "addmv", 545.0, 4.0, 9),
        launch(600.0, 10), _x("kernel", "div", 605.0, 4.0, 10),
        launch(660.0, 11, "cudaMemcpyAsync", 20.0), _x("gpu_memcpy", "Memcpy DtoH", 670.0, 1.0, 11),
        note("sketch.bank.counters", 1100.0, 1200.0),  # after the window: left out
    ]


def test_trace_keeps_the_port_spans_with_launches_syncs_and_parents():
    spans = trace.summarize(_dashboard_iteration()).spans
    want = {  # wall, wait, device (us); CUDA calls, launches, syncs; parent
        "perfbench.call": (300, 85, 202, 7, 5, 1, ""),
        "sketch.bank.update_many": (280, 85, 202, 7, 5, 1, "perfbench.call"),
        "sketch.bank.counters": (170, 85, 52, 5, 3, 1, "sketch.bank.update_many"),
        "perfbench.read": (300, 75, 70, 6, 5, 1, ""),
        "sketch.bank.estimate_many": (245, 55, 69, 5, 4, 1, "perfbench.read"),
        "sketch.estimate.histogram": (105, 55, 61, 3, 2, 1, "sketch.bank.estimate_many"),
        "sketch.estimate.finalize": (100, 0, 8, 2, 2, 0, "sketch.bank.estimate_many"),
    }
    assert set(spans) == set(want)  # the seams and the window are not spans
    for name, (wall, wait, device, cuda_calls, launches, syncs, parent) in want.items():
        (s,) = spans[name]
        assert (s.wall_s, s.wait_s, s.device_s) == pytest.approx((wall * 1e-6, wait * 1e-6, device * 1e-6)), name
        assert (s.cuda_calls, s.launches, s.syncs, s.parent) == (cuda_calls, launches, syncs, parent), name
        # the tick's spans lie in the window's first call; the read in none
        assert s.call == (-1 if name.endswith(("read", "estimate_many", "histogram", "finalize")) else 0), name


def test_readers_of_the_port_spans():
    rec = harness.Record({"system": "sketch_bank"}, {}, trace.summarize(_dashboard_iteration()))
    read = lambda name: harness.metric_reader(name)(rec)
    assert read("launches.fleet") == 5  # the tick's top span; its read is not a call
    assert read("syncs.dashboard") == 2.0  # the tick's and the histogram's, over one call
    assert read("counters_us.fleet") == pytest.approx(52.0)
    assert read("histogram_us.dashboard") == pytest.approx(61.0)
    assert read("finalize_host_us.dashboard") == pytest.approx(100.0)
    # the harness's own spans read as before beside them
    assert read("host_us.fleet") == pytest.approx(300.0 - 85.0)
    assert read("estimate_us.dashboard") == pytest.approx(70.0)
    # spans that hold no CUDA call (a CPU run), or no spans: nothing is read
    hostless = [e for e in _dashboard_iteration() if e["cat"] == "user_annotation"]
    for trace_of in (trace.summarize(hostless), trace.Trace(busy_s=0.0, window_s=1.0, device_ops=[], idle_gaps=[])):
        rec.trace = trace_of
        for name in ("launches.fleet", "syncs.dashboard", "counters_us.fleet", "histogram_us.dashboard",
                     "finalize_host_us.dashboard"):
            assert read(name) is None, name


def test_launches_read_the_span_a_call_opens_whatever_its_name():
    note = lambda name, t0, t1: _x("user_annotation", name, t0, t1 - t0)
    events = [note(trace.WINDOW, 0.0, 1000.0)]
    for i, (t, top) in enumerate(((0.0, "sketch.update"), (300.0, "sketch.update"), (600.0, "sketch.cm.update"))):
        events += [note("perfbench.call", t, t + 150.0), note(top, t + 5, t + 140.0),
                   note("sketch.inner", t + 10, t + 60.0)]
        events += [x for k in range(3) for x in (_x("cuda_runtime", "cudaLaunchKernel", t + 20 + 10 * k, 2.0,
                                                    10 * i + k), _x("kernel", "k", t + 200, 5.0, 10 * i + k))]
    rec = harness.Record({"system": "hll_stream"}, {}, trace.summarize(events))
    assert harness.metric_reader("launches.stream")(rec) == 3
    assert harness.metric_reader("syncs.dashboard")(rec) == 0.0
    assert {s.parent for s in rec.trace.spans["sketch.inner"]} == {"sketch.update", "sketch.cm.update"}


def test_launches_sum_the_port_spans_of_one_call():
    """A call whose entry point opens two port spans in turn launches what
    both launch: launches and syncs agree on what one call is."""
    note = lambda name, t0, t1: _x("user_annotation", name, t0, t1 - t0)
    launch = lambda ts, corr: _x("cuda_runtime", "cudaLaunchKernel", ts, 2.0, corr)
    events = [note(trace.WINDOW, 0.0, 1000.0)]
    for i, t in enumerate((0.0, 400.0)):
        events += [note("perfbench.call", t, t + 300.0), note("sketch.cm.update", t + 5, t + 100.0),
                   note("sketch.cm.vote", t + 120, t + 280.0)]
        events += [launch(t + 10 + 10 * k, 10 * i + k) for k in range(2)]
        events += [launch(t + 130 + 10 * k, 10 * i + 5 + k) for k in range(3)]
        events += [_x("cuda_runtime", "cudaStreamSynchronize", t + 200, 5.0)]
        events += [_x("kernel", "k", t + 350, 1.0, 10 * i + k) for k in (0, 1, 5, 6, 7)]
    rec = harness.Record({"system": "count_min"}, {}, trace.summarize(events))
    assert [s.call for s in rec.trace.spans["sketch.cm.vote"]] == [0, 1]
    assert harness.metric_reader("launches.fleet")(rec) == 5
    assert harness.metric_reader("syncs.dashboard")(rec) == 1.0
