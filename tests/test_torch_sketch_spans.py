"""The sketch path's spans in a profile, reduced by ``tools/sketch_spans.py``.

* A synthetic trace of a dashboard iteration (a tick and its read, with
  the port's spans nested inside the benchmark's marks) and of a stream
  call: each span's launches, syncs, device time and waits, and the
  readings made of them; the tool's rules for waits and correlation.
* The port profiled on the CPU along each benchmark cell's path: the
  spans are found, and each reading is None, as no CUDA call runs.
* On the card (``gpu``): the counters' and the estimator histogram's
  spans hold device time, found by correlation id, so they share the
  device trace's clock and enclose their launches.

The tool's reduction is its own; these tests import nothing of the
benchmark.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _load_tool():
    spec = importlib.util.spec_from_file_location("sketch_spans", ROOT / "tools" / "sketch_spans.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


spans_tool = _load_tool()


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, name="cudaLaunchKernel", dur=5.0):
    return _x("cuda_runtime", name, ts, dur, corr)


def _dashboard_trace():
    """One tick (its scatter, then the counters with a copy to the host and
    a synchronize) and one read (the histogram with its own sync, then a
    finalize of two small kernels), then the read's copy of the estimates."""
    note = lambda name, t0, t1: _x("user_annotation", name, t0, t1 - t0)
    return [
        note("perfbench.window", 0.0, 1000.0),
        note("perfbench.call", 0.0, 300.0),
        note("sketch.bank.update_many", 10.0, 290.0),
        note("bank_update[cuda]", 20.0, 100.0),
        _launch(30.0, 1), _x("kernel", "hash_rank_kernel", 40.0, 50.0, 1),
        _launch(60.0, 2), _x("kernel", "bank_scatter_kernel", 90.0, 100.0, 2),
        note("sketch.bank.counters", 110.0, 280.0),
        _launch(120.0, 3), _x("kernel", "where", 190.0, 20.0, 3),
        _launch(130.0, 4, "cudaMemcpyAsync", 80.0), _x("gpu_memcpy", "Memcpy DtoH", 210.0, 2.0, 4),
        _x("cuda_runtime", "cudaStreamSynchronize", 215.0, 5.0),
        _launch(230.0, 5), _x("kernel", "kernelHistogram1D", 240.0, 30.0, 5),
        _x("cuda_runtime", "cudaGetDevice", 250.0, 1.0, 6),  # a CUDA call with no device work
        note("perfbench.read", 400.0, 700.0),
        note("sketch.bank.estimate_many", 405.0, 650.0),
        note("estimate[original]", 410.0, 640.0),
        note("sketch.estimate.histogram", 415.0, 520.0),
        _launch(420.0, 7), _x("kernel", "kernelHistogram1D", 430.0, 60.0, 7),
        _launch(440.0, 8, "cudaMemcpyAsync", 52.0), _x("gpu_memcpy", "Memcpy DtoH", 490.0, 1.0, 8),
        _x("cuda_runtime", "cudaStreamSynchronize", 495.0, 3.0),
        note("sketch.estimate.finalize", 530.0, 630.0),
        _launch(540.0, 9), _x("kernel", "addmv", 545.0, 4.0, 9),
        _launch(600.0, 10), _x("kernel", "div", 605.0, 4.0, 10),
        _launch(660.0, 11, "cudaMemcpyAsync", 20.0), _x("gpu_memcpy", "Memcpy DtoH", 670.0, 1.0, 11),
        note("sketch.bank.counters", 1100.0, 1200.0),  # after the window: left out
    ]


def test_span_stats_count_launches_syncs_waits_and_device_time():
    spans = spans_tool.span_stats(_dashboard_trace())
    want = {  # wall, wait, device (us); CUDA calls, launches, syncs
        "sketch.bank.update_many": (280, 85, 202, 7, 5, 1),
        "bank_update[cuda]": (80, 0, 150, 2, 2, 0),
        "sketch.bank.counters": (170, 85, 52, 5, 3, 1),
        "sketch.bank.estimate_many": (245, 55, 69, 5, 4, 1),
        "estimate[original]": (230, 55, 69, 5, 4, 1),
        "sketch.estimate.histogram": (105, 55, 61, 3, 2, 1),
        "sketch.estimate.finalize": (100, 0, 8, 2, 2, 0),
        "perfbench.call": (300, 85, 202, 7, 5, 1),
        "perfbench.read": (300, 75, 70, 6, 5, 1),
    }
    assert set(spans) == set(want)
    for name, (wall, wait, device, cuda_calls, launches, syncs) in want.items():
        (s,) = spans[name]
        assert (s.wall_s, s.wait_s, s.device_s) == pytest.approx((wall * 1e-6, wait * 1e-6, device * 1e-6)), name
        assert (s.cuda_calls, s.launches, s.syncs) == (cuda_calls, launches, syncs), name


def test_readings_of_a_dashboard_iteration():
    got = spans_tool.readings(spans_tool.span_stats(_dashboard_trace()))
    assert got["launches.stream"] is None
    assert got["launches.fleet"] == 5
    assert got["syncs"] == 2.0  # the tick's and the histogram's, in the port's top spans
    assert got["counters_us"] == pytest.approx(52.0)
    assert got["histogram_us"] == pytest.approx(61.0)
    assert got["finalize_host_us"] == pytest.approx(100.0)


def test_readings_of_stream_calls_and_of_nothing():
    note = lambda name, t0, t1: _x("user_annotation", name, t0, t1 - t0)
    events = [note("perfbench.window", 0.0, 500.0)]
    for i, t in enumerate((0.0, 200.0)):
        events += [note("perfbench.call", t, t + 150.0), note("sketch.update", t + 5, t + 140.0),
                   note("update[cuda]", t + 10, t + 60.0),
                   _launch(t + 20, 10 * i + 1), _x("kernel", "hll_file_kernel", t + 30, 300.0, 10 * i + 1),
                   _launch(t + 40, 10 * i + 2), _x("kernel", "hll_merge_kernel", t + 330, 5.0, 10 * i + 2),
                   _launch(t + 80, 10 * i + 3), _x("kernel", "add", t + 340, 2.0, 10 * i + 3)]
    got = spans_tool.readings(spans_tool.span_stats(events))
    assert got["launches.stream"] == 3 and got["syncs"] == 0.0
    assert {k for k, v in got.items() if v is None} == {"launches.fleet", "counters_us", "histogram_us",
                                                        "finalize_host_us"}
    # no span at all, or spans that hold no CUDA call (a CPU run): nothing is read
    assert set(spans_tool.readings({}).values()) == {None}
    hostless = [e for e in _dashboard_trace() if e["cat"] == "user_annotation"]
    assert set(spans_tool.readings(spans_tool.span_stats(hostless)).values()) == {None}


def test_span_stats_need_one_window():
    with pytest.raises(ValueError, match="perfbench.window"):
        spans_tool.span_stats([e for e in _dashboard_trace() if e["name"] != "perfbench.window"])


def test_waits_are_synchronizes_and_copies():
    blocking = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cuStreamSynchronize", "cudaMemcpyAsync",
                "cuMemcpyDtoHAsync_v2")
    queued = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemsetAsync", "cudaGetDevice")
    assert [spans_tool.waits(name) for name in blocking + queued] == [True] * 5 + [False] * 4


def test_device_time_is_found_by_correlation_id_alone():
    # a kernel that runs long after its launch, past the span's end, is the
    # span's; one launched outside the span is not, even while it runs inside
    note = lambda name, t0, t1: _x("user_annotation", name, t0, t1 - t0)
    events = [note("perfbench.window", 0.0, 1000.0), note("perfbench.call", 100.0, 200.0),
              _launch(50.0, 1), _x("kernel", "early", 120.0, 70.0, 1),
              _launch(110.0, 2), _x("kernel", "late", 600.0, 30.0, 2),
              _x("kernel", "orphan", 150.0, 10.0)]
    (call,) = spans_tool.span_stats(events)["perfbench.call"]
    assert call.device_s == pytest.approx(30e-6) and (call.cuda_calls, call.launches) == (1, 1)


def _profiled_events(loop, device, tmp_path) -> list:
    """The Chrome trace events of ``loop()`` in a window and a call range,
    as the benchmark's traced window marks them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        with record_function(spans_tool.WINDOW):
            for _ in range(3):
                with record_function("perfbench.call"):
                    loop()
            if on_card:
                torch.cuda.synchronize(device)
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _cell_path(cell: str, device, rows: int, n: int):
    """One call of a benchmark cell's path: a stream chunk into a sketch
    (p = 16), or a Zipf-keyed tick into a p = 12 bank (and its read)."""
    from repro_torch.sketch import ExecutionPlan, HLLConfig, HyperLogLog, SketchBank

    gen = torch.Generator(device=device).manual_seed(2**31 + 11)
    items = torch.randint(0, 2**31 - 1, (n,), generator=gen, device=device, dtype=torch.int32)
    plan = ExecutionPlan(backend="cuda" if device.type == "cuda" else "torch")
    if cell == "nic_stream.bulk":
        sk = HyperLogLog.empty(HLLConfig(p=16, hash_bits=64), device)
        return lambda: sk.update(items, plan)
    keys = (torch.rand(n, generator=gen, device=device).pow(4) * rows).to(torch.int32)
    bank = SketchBank.empty(rows, HLLConfig(p=12, hash_bits=64), device)
    if cell == "tenant_fleet.ingest":
        return lambda: bank.update_many(keys, items, plan)
    return lambda: bank.update_many(keys, items, plan).estimate_many("original", plan)


@pytest.mark.parametrize("cell,found", [
    ("nic_stream.bulk", {"sketch.update", "update[torch]"}),
    ("tenant_fleet.ingest", {"sketch.bank.update_many", "sketch.bank.counters", "bank_update[torch]"}),
    ("tenant_fleet.dashboard", {"sketch.bank.update_many", "sketch.bank.counters", "sketch.bank.estimate_many",
                                "estimate[original]", "sketch.estimate.histogram", "sketch.estimate.finalize"}),
])
def test_cpu_profile_of_each_cell_path_finds_the_spans_and_reads_nothing(cell, found, tmp_path):
    device = torch.device("cpu")
    events = _profiled_events(_cell_path(cell, device, 8, 1 << 10), device, tmp_path)
    spans = spans_tool.span_stats(events, spans_tool.NAMES + ("update[torch]", "bank_update[torch]"))
    assert found <= set(spans) and len(spans["perfbench.call"]) == 3
    assert all(len(spans[name]) == 3 for name in found)
    assert set(spans_tool.readings(spans).values()) == {None}


@pytest.mark.gpu
def test_counter_and_histogram_spans_hold_device_time_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda")
    loop = _cell_path("tenant_fleet.dashboard", device, 64, 1 << 20)
    loop()  # builds the kernels
    spans = spans_tool.span_stats(_profiled_events(loop, device, tmp_path))
    got, split = spans_tool.readings(spans), spans_tool.split(spans)
    assert got["counters_us"] > 0 and got["histogram_us"] > 0 and got["finalize_host_us"] > 0
    assert got["launches.fleet"] >= 3 and got["syncs"] >= 1
    assert split["bank_update[cuda]"]["device_us"] > 0
    assert all(split[name]["device_us"] <= split["perfbench.call"]["device_us"]
               for name in ("sketch.bank.counters", "bank_update[cuda]", "sketch.estimate.histogram"))
