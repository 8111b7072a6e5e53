"""Port vs reference: the observability layer (``repro_torch.obs``).

* The port's counterpart of each test in ``tests/test_obs.py``: disabled
  is a true no-op, record sites stand down while ``torch.compile`` traces
  (where the reference's stand down under ``jax.jit``), ``to_json()``
  round-trips the snapshot, spans emit Chrome trace events with the
  dispatch seams under them.
* A differential test: one op sequence (bank tick, single-sketch update,
  hybrid ingest + settle, window observe/advance/read twice, count-min
  tick, ``estimate_many``) through both packages with metrics enabled,
  under each pair of backends (``jnp``/``torch``, ``pallas``/``cuda``,
  ``pallas_pipelined``/``cuda_pipelined``): the same counter names and
  values, histogram names and counts, non-time histogram sums and gauges.
* The ``format`` helpers against the reference's over a grid of values
  with 0, inf, -inf and nan.

The registries of both packages are process-global, so a fixture turns
metrics off and clears them, stops any trace and drops the shared window
rings before and after every test.  The reference's enabled-metrics paths
need ``jax.core.trace_state_clean``, which jax 0.9.0 moved (ROADMAP C):
the fixture aliases it.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import format as ref_format
from repro.obs import metrics as ref_metrics
from repro.obs import tracing as ref_tracing
from repro.serve.coalesce import SharedWindowRing as RefSharedRing
from repro import sketch as ref_sketch
from repro_torch import sketch
from repro_torch.obs import format, metrics, tracing
from repro_torch.obs.format import (
    fmt_bytes,
    fmt_count,
    fmt_pct,
    fmt_rate,
    fmt_seconds,
    kv_line,
    metrics_report_line,
    truncated_note,
)
from repro_torch.serve.coalesce import SharedWindowRing
from repro_torch.sketch import (
    ExecutionPlan,
    HLLConfig,
    SketchBank,
    estimate_many,
    register_backend,
    register_bank_backend,
)
from repro_torch.sketch import plan as plan_module
from repro_torch.sketch.backends import bank_update_torch, update_pipelined
from repro_torch.sketch.dispatch import update_registers
from repro_torch.sketch.plan import get_bank_backend

CFG = HLLConfig(p=6, hash_bits=32)
SPY = "obs_spy_torch"
BACKEND_PAIRS = (("jnp", "torch"), ("pallas", "cuda"), ("pallas_pipelined", "cuda_pipelined"))
NAMES = dict(BACKEND_PAIRS)


def _clean():
    for m, t in ((metrics, tracing), (ref_metrics, ref_tracing)):
        m.disable()
        m.reset()
        if t.active():
            t.stop_trace()
    SharedWindowRing.reset()
    RefSharedRing.reset()


@pytest.fixture(autouse=True)
def _clean_obs_state(monkeypatch):
    """Every test starts and ends with metrics off/empty, no trace and no
    shared ring, in both packages."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    _clean()
    yield
    _clean()


@pytest.fixture
def spy():
    """A spy backend on the update and bank axes, delegating to the torch
    paths; removed afterwards so backend-sweeping suites never see it."""
    calls = {"n": 0}

    def single(registers, items, cfg, plan):
        calls["n"] += 1
        return update_pipelined(registers, items, cfg, plan.pipelines)

    def bank(registers, keys, items, cfg, plan):
        calls["n"] += 1
        return bank_update_torch(registers, keys, items, cfg)

    register_backend(SPY)(single)
    register_bank_backend(SPY)(bank)
    yield calls
    plan_module._BACKENDS.pop(SPY, None)
    plan_module._BANK_BACKENDS.pop(SPY, None)


def _ingest(bank, n=32, backend="torch"):
    keys = torch.arange(n, dtype=torch.int32) % 4
    items = torch.arange(n, dtype=torch.int32)
    return bank.update_many(keys, items, plan=ExecutionPlan(backend=backend))


def _empty(rows=4):
    return SketchBank.empty(rows, CFG, device="cpu")


# ----------------------------------------------------------------------------
# disabled default: true no-op
# ----------------------------------------------------------------------------


def test_disabled_by_default_registry_stays_empty():
    assert not metrics.enabled()
    bank = _ingest(_empty())
    estimate_many(bank.registers, CFG)
    snap = metrics.snapshot()
    assert snap["enabled"] is False
    assert snap["counters"] == {}
    assert snap["gauges"] == {}
    assert snap["histograms"] == {}


def test_disabled_adds_zero_backend_dispatches(spy):
    """The seam wrapper forwards exactly one call per real dispatch."""
    bank = _empty()
    bank = _ingest(bank, backend=SPY)
    assert spy["n"] == 1  # wrapped, not doubled
    # empty streams short-circuit BEFORE the wrapper: no dispatch, and
    # nothing counted even with metrics on
    metrics.enable()
    spy["n"] = 0
    out = bank.update_many(
        torch.zeros((0,), dtype=torch.int32),
        torch.zeros((0,), dtype=torch.int32),
        plan=ExecutionPlan(backend=SPY),
    )
    assert out is bank and spy["n"] == 0
    assert metrics.counter_value(f"dispatch.bank_update.{SPY}.calls") == 0
    # the single-sketch path counts its skips so the no-dispatch contract
    # stays observable
    regs = update_registers(
        torch.zeros((CFG.m,), dtype=torch.uint8),
        torch.zeros((0,), dtype=torch.int32),
        CFG,
        ExecutionPlan(backend=SPY),
    )
    assert regs.shape == (CFG.m,) and spy["n"] == 0
    assert metrics.counter_value("dispatch.update.skipped_empty") == 1


def test_record_sites_noop_when_disabled():
    metrics.inc("x")
    metrics.gauge("g", 3.0)
    metrics.observe("h", 1.0)
    with metrics.timed("t"):
        pass
    assert metrics.snapshot()["counters"] == {}
    assert metrics.counter_value("x") == 0


# ----------------------------------------------------------------------------
# enabled: dispatch seams count and time
# ----------------------------------------------------------------------------


def test_enabled_counts_dispatches_per_axis_and_backend():
    metrics.enable()
    bank = _ingest(_empty())
    estimate_many(bank.registers, CFG, estimator="original")
    snap = metrics.snapshot()
    assert snap["counters"]["dispatch.bank_update.torch.calls"] == 1
    assert snap["histograms"]["dispatch.bank_update.torch.seconds"]["count"] == 1
    assert snap["counters"]["dispatch.estimate.original.calls"] == 1
    assert snap["histograms"]["bank.update_many.batch_items"]["count"] == 1
    assert snap["histograms"]["bank.update_many.batch_items"]["max"] == 32.0


def test_reset_clears_but_keeps_enabled():
    metrics.enable()
    metrics.inc("a")
    metrics.reset()
    snap = metrics.snapshot()
    assert snap["enabled"] is True and snap["counters"] == {}


# ----------------------------------------------------------------------------
# compile safety: no record site runs while torch.compile traces
# ----------------------------------------------------------------------------


def test_record_sites_skipped_under_compile():
    metrics.enable()

    def f(x):
        metrics.inc("jit.counter")
        metrics.gauge("jit.gauge", 1.0)
        metrics.observe("jit.hist", 2.0)
        with metrics.timed("jit.timed"):
            y = x + 1
        return y

    g = torch.compile(f, backend="eager")
    g(torch.arange(4))  # traces + runs
    g(torch.arange(4))  # compiled: the graph replays without the sites
    snap = metrics.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {}
    assert snap["histograms"] == {}


def test_wrapped_backend_seam_skipped_under_compile():
    """Tracing a compiled caller must not book a dispatch the graph
    replays without running Python again."""
    metrics.enable()
    wrapped = get_bank_backend("torch")
    plan = ExecutionPlan(backend="torch")
    regs = _empty().registers
    keys = torch.arange(8, dtype=torch.int32) % 4
    items = torch.arange(8, dtype=torch.int32)

    g = torch.compile(lambda r, k, x: wrapped(r, k, x, CFG, plan), backend="eager")
    inside = g(regs, keys, items)
    g(regs, keys, items)
    assert metrics.counter_value("dispatch.bank_update.torch.calls") == 0
    # ...while the same wrapped fn called eagerly records exactly once
    outside = wrapped(regs, keys, items, CFG, plan)
    assert metrics.counter_value("dispatch.bank_update.torch.calls") == 1
    assert torch.equal(inside, outside)


def test_span_under_compile_emits_no_event():
    tracing.start_trace()

    def f(x):
        with tracing.span("traced.body"):
            return x * 2

    torch.compile(f, backend="eager")(torch.arange(3))
    events = tracing.stop_trace()
    assert all(e["name"] != "traced.body" for e in events)


# ----------------------------------------------------------------------------
# snapshot schema / to_json round-trip
# ----------------------------------------------------------------------------


def test_to_json_roundtrips_snapshot():
    metrics.enable()
    metrics.inc("c", 3)
    metrics.gauge("g", 2.5)
    for v in (0.001, 0.01, 0.1):
        metrics.observe("h", v)
    snap = metrics.snapshot()
    assert json.loads(metrics.to_json()) == snap
    assert set(snap) == {"enabled", "counters", "gauges", "histograms"}
    hist = snap["histograms"]["h"]
    assert set(hist) == {"count", "sum", "mean", "min", "max", "p50", "p90", "p99"}
    assert hist["count"] == 3
    assert hist["min"] == pytest.approx(0.001)
    assert hist["max"] == pytest.approx(0.1)


def test_histogram_percentiles_sane():
    metrics.enable()
    for v in range(1, 1001):
        metrics.observe("lat", float(v))
    h = metrics.snapshot()["histograms"]["lat"]
    assert h["count"] == 1000
    assert h["mean"] == pytest.approx(500.5)
    # log-binned at 4 bins/decade: estimates land within one bin (~1.78x)
    assert 500 / 1.78 <= h["p50"] <= 500 * 1.78
    assert 900 / 1.78 <= h["p90"] <= 1000.0
    assert h["p99"] <= h["max"] <= 1000.0
    assert h["min"] == 1.0


def test_snapshot_and_json_equal_the_reference_for_the_same_records():
    """Same bins, percentiles and JSON text as the reference's registry."""
    values = [0.0, 1e-9, 3e-7, 0.002, 0.5, 1.0, 7.0, 1234.5, 1e9, 5e9]
    for m in (metrics, ref_metrics):
        m.enable()
        m.inc("c", 3)
        m.inc("c")
        m.gauge("g", 2.5)
        for v in values:
            m.observe("h", v)
    assert metrics._EDGES == ref_metrics._EDGES
    assert metrics.snapshot() == ref_metrics.snapshot()
    assert metrics.to_json() == ref_metrics.to_json()
    assert metrics.to_json(indent=None) == ref_metrics.to_json(indent=None)


# ----------------------------------------------------------------------------
# tracing: spans, nesting, Chrome-trace shape, seam events
# ----------------------------------------------------------------------------


def test_span_times_and_chrome_trace_shape():
    tracing.start_trace()
    with tracing.span("outer", phase="test") as outer:
        with tracing.span("inner") as inner:
            sum(range(1000))
    tracing.stop_trace()
    assert 0 < inner.elapsed_s <= outer.elapsed_s
    doc = tracing.chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    events = {e["name"]: e for e in doc["traceEvents"]}
    assert set(events) == {"outer", "inner"}
    for e in events.values():
        assert e["ph"] == "X" and e["dur"] >= 0 and "pid" in e and "tid" in e
    # nesting is reconstructed from containment: inner within outer
    o, i = events["outer"], events["inner"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    assert o["args"] == {"phase": "test"}
    json.dumps(doc)  # Perfetto-loadable


def test_span_metric_feeds_histogram():
    metrics.enable()
    with tracing.span("req", metric="req.seconds"):
        pass
    assert metrics.snapshot()["histograms"]["req.seconds"]["count"] == 1


def test_dispatch_seams_emit_trace_events():
    tracing.start_trace()
    _ingest(_empty())
    tracing.stop_trace()
    names = {e["name"] for e in tracing.chrome_trace()["traceEvents"]}
    assert "bank_update[torch]" in names
    # ...and nothing is recorded in the metrics registry by a pure trace
    assert metrics.snapshot()["counters"] == {}


def test_write_trace_and_buffer_lifecycle(tmp_path):
    tracing.start_trace()
    with tracing.span("once"):
        pass
    tracing.stop_trace()
    path = tracing.write_trace(str(tmp_path / "t.json"))
    with open(path) as f:
        assert len(json.load(f)["traceEvents"]) == 1
    with tracing.span("after_stop"):  # capture over: not buffered
        pass
    assert len(tracing.chrome_trace()["traceEvents"]) == 1
    tracing.start_trace()  # restarting clears the old buffer
    assert tracing.chrome_trace()["traceEvents"] == []
    tracing.stop_trace()


def test_trace_events_have_the_reference_fields():
    for t in (tracing, ref_tracing):
        t.start_trace()
        with t.span("outer", request=3, phase="x"):
            pass
        t.stop_trace()
    mine, theirs = tracing.chrome_trace(), ref_tracing.chrome_trace()
    assert set(mine) == set(theirs) and mine["displayTimeUnit"] == theirs["displayTimeUnit"]
    (a,), (b,) = mine["traceEvents"], theirs["traceEvents"]
    assert set(a) == set(b) and a["args"] == b["args"] == {"request": "3", "phase": "x"}
    assert (a["name"], a["ph"], a["pid"], a["tid"]) == (b["name"], b["ph"], b["pid"], b["tid"])


def test_stopwatch_semantics():
    w = tracing.Stopwatch()
    assert not w.running
    with pytest.raises(AssertionError):
        w.elapsed()
    w.start()
    assert w.running and w.elapsed() >= 0
    dt = w.stop()
    assert dt >= 0 and not w.running


# ----------------------------------------------------------------------------
# formatting helpers (serve report lines)
# ----------------------------------------------------------------------------


def test_format_helpers():
    assert fmt_count(1234567) == "1,234,567"
    assert fmt_pct(0.6667) == "66.7%"
    assert fmt_seconds(0.0000012) == "1µs"
    assert fmt_seconds(0.0034) == "3.4ms"
    assert fmt_seconds(2.5) == "2.50s"
    assert fmt_rate(1.25e6, "tok") == "1,250,000 tok/s"
    assert fmt_bytes(3 * 1024**2) == "3.0MiB"
    assert kv_line("board", [("rows", 4), ("hit", "66.7%")]) == (
        "  board: rows=4 hit=66.7%"
    )
    note = truncated_note(3, 8, "requests")
    assert "+5 more requests" in note and "8 total" in note


def test_metrics_report_line_reads_snapshot():
    metrics.enable()
    _ingest(_empty())
    metrics.observe("serve.request.seconds", 0.002)
    metrics.inc("window.fold_cache.hits", 2)
    metrics.inc("window.fold_cache.misses", 1)
    line = metrics_report_line(metrics.snapshot())
    assert line.startswith("[metrics]")
    assert "p50=" in line and "dispatches=" in line and "hit=66.7%" in line


GRID = [0, 0.0, -0.0, 1, -1, 0.4999, 0.5, 1.5, 2.5, 999.5, 1e-7, 1.2e-6, 9.99e-4, 1e-3, 0.0034, 0.99999,
        1.0, 2.5, 1023, 1024, 1024**2 - 1, 3 * 1024**2, 1024**3 * 1.5, 1234567, 1e15, 1e300,
        math.inf, -math.inf, math.nan]
ONE_ARG = ("fmt_count", "fmt_float", "fmt_pct", "fmt_seconds", "fmt_bytes")


@pytest.mark.parametrize("name", ONE_ARG)
def test_format_helper_matches_reference_over_the_grid(name):
    mine, theirs = getattr(format, name), getattr(ref_format, name)
    for x in GRID:
        try:
            want = theirs(x)
        except (OverflowError, ValueError) as e:  # pragma: no cover - none expected
            with pytest.raises(type(e)):
                mine(x)
            continue
        assert mine(x) == want, (name, x)


def test_digits_rate_and_lines_match_reference_over_the_grid():
    for x in GRID:
        for digits in (0, 1, 2):
            assert format.fmt_float(x, digits) == ref_format.fmt_float(x, digits)
            assert format.fmt_pct(x, digits) == ref_format.fmt_pct(x, digits)
        assert format.fmt_rate(x, "tok") == ref_format.fmt_rate(x, "tok")
        pairs = [("v", format.fmt_count(x)), ("s", format.fmt_seconds(x))]
        assert format.kv_line(f"row[{x}]", pairs) == ref_format.kv_line(f"row[{x}]", pairs)
    for shown, total in ((0, 0), (3, 8), (4, 4), (1, 1000)):
        assert format.truncated_note(shown, total, "requests") == ref_format.truncated_note(shown, total, "requests")


def test_per_second_matches_reference_over_the_grid():
    # "inf tok/s" for finite work in zero time, 0.0 for none (CHANGES PR 10)
    assert format.per_second(2048, 0.0) == math.inf
    assert format.per_second(0, 0.0) == 0.0
    for count in GRID:
        for elapsed in GRID:
            got, want = format.per_second(count, elapsed), ref_format.per_second(count, elapsed)
            assert got == want or (math.isnan(got) and math.isnan(want)), (count, elapsed)


def test_metrics_report_line_matches_reference():
    snaps = [
        {},
        {"counters": {}, "histograms": {"serve.request.seconds": {"count": 0, "p50": 0.0, "p99": 0.0}}},
        {
            "counters": {"dispatch.bank_update.cuda.calls": 3, "dispatch.estimate.original.calls": 2,
                         "dispatch.update.skipped_empty": 5, "sparse.flush.read": 1,
                         "sparse.flush.pressure": 2, "window.fold_cache.hits": 2,
                         "window.fold_cache.misses": 1},
            "histograms": {"serve.request.seconds": {"count": 4, "p50": 0.000153, "p99": 0.0021}},
        },
        {"counters": {"window.fold_cache.hits": 0, "window.fold_cache.misses": 0}},
    ]
    for snap in snaps:
        assert metrics_report_line(snap) == ref_format.metrics_report_line(snap)


# ----------------------------------------------------------------------------
# differential: one op sequence, both packages, the same snapshot
# ----------------------------------------------------------------------------


def _op_sequence(pkg, backend: str, place) -> None:
    """bank tick, single-sketch update, hybrid ingest + settle, window
    observe/advance/read twice, count-min tick, estimate_many."""
    rng = np.random.default_rng(20261017)
    rows, cfg = 9, pkg.HLLConfig(p=8, hash_bits=64)
    plan = pkg.ExecutionPlan(backend=backend, pipelines=3)

    def batch(n):
        keys = rng.integers(-1, rows + 1, n).astype(np.int32)  # -1 and B dropped
        items = rng.integers(0, 2**31, n).astype(np.int32)
        return keys, items

    keys, items = batch(700)
    bank = place(pkg.SketchBank.empty, rows, cfg).update_many(keys, items, plan)
    place(pkg.HyperLogLog.empty, cfg).update(items[:300], plan).update(items[:0], plan)
    hyb = place(pkg.HybridBank.empty, rows, cfg, threshold=8)
    for n in (40, 900, 30):
        hyb = hyb.update_many(*batch(n), plan)
    hyb.estimate_many(plan=plan)
    hyb.density()
    ring = place(pkg.WindowedBank.empty, 3, rows, cfg)
    for n in (200, 150):
        ring = ring.observe(*batch(n), plan).advance()
        ring.estimate_window(plan=plan)
        ring.estimate_window(plan=plan)
        ring.estimate_window(2, plan)
    cm = place(pkg.CountMinBank.empty, rows, pkg.CMConfig(depth=2, width=64))
    cm.update_many(*batch(500), plan)
    pkg.estimate_many(bank.registers, cfg)


def _reference_names(snap: dict, names: dict) -> dict:
    """The reference's snapshot with its backend names in the port's."""

    def rename(key):
        parts = key.split(".")
        if parts[0] == "dispatch" and len(parts) == 4 and parts[2] in names:
            parts[2] = names[parts[2]]
        return ".".join(parts)

    return {kind: {rename(k): v for k, v in snap[kind].items()} for kind in ("counters", "gauges", "histograms")}


def _time_metric(name: str) -> bool:
    return name.endswith(".seconds") or name == "serve.items_per_s"


def assert_snapshots_agree(mine: dict, theirs: dict, names: dict = NAMES) -> None:
    """Counters equal; histogram names and counts equal; sums of non-time
    histograms and every non-time gauge equal (wall times excepted).
    ``names`` maps the reference's backend names to the port's."""
    theirs = _reference_names(theirs, names)
    assert mine["counters"] == theirs["counters"]
    assert set(mine["histograms"]) == set(theirs["histograms"])
    for name, hist in theirs["histograms"].items():
        assert mine["histograms"][name]["count"] == hist["count"], name
        if not _time_metric(name):
            assert mine["histograms"][name] == hist, name
    assert set(mine["gauges"]) == set(theirs["gauges"])
    for name, value in theirs["gauges"].items():
        if not _time_metric(name):
            assert mine["gauges"][name] == value, name


@pytest.mark.parametrize("ref_backend,backend", BACKEND_PAIRS)
def test_op_sequence_snapshot_matches_reference(ref_backend, backend):
    ref_metrics.enable()
    _op_sequence(ref_sketch, ref_backend, lambda make, *a, **k: make(*a, **k))
    metrics.enable()
    _op_sequence(sketch, backend, lambda make, *a, **k: make(*a, **k, device="cpu"))
    mine, theirs = metrics.snapshot(), ref_metrics.snapshot()
    assert_snapshots_agree(mine, theirs)
    # the sequence reaches every record site of the sketch modules
    assert {"sparse.flush.read", "sparse.pending.appends", "window.prefix_rebuilds",
            "window.fold_cache.hits", "window.fold_cache.misses",
            f"dispatch.cm_update.{backend}.calls", f"dispatch.sparse_dedup.{backend}.calls",
            f"dispatch.window_merge.{backend}.calls", f"dispatch.window_fold.{backend}.calls"} <= set(mine["counters"])
    assert {"bank.update_many.batch_items", "cm.update_many.batch_items", "update.batch_items"} <= set(
        mine["histograms"])


def test_op_sequence_trace_shows_the_same_seams_as_reference():
    ref_tracing.start_trace()
    _op_sequence(ref_sketch, "jnp", lambda make, *a, **k: make(*a, **k))
    ref_events = ref_tracing.stop_trace()
    tracing.start_trace()
    _op_sequence(sketch, "torch", lambda make, *a, **k: make(*a, **k, device="cpu"))
    events = tracing.stop_trace()
    rename = lambda name: name.replace("[jnp]", "[torch]")
    assert [e["name"] for e in events] == [rename(e["name"]) for e in ref_events]
    assert metrics.snapshot()["counters"] == {}


def test_pressure_flush_and_promotions_are_counted_like_reference(monkeypatch):
    """The hybrid bank's pressure flush and promotions, which the serve
    path's small streams never reach (the log's floor lowered from 2^22
    pairs to 2^10 in both packages, so that a small stream crosses it)."""
    from repro.sketch import sparse as ref_sparse
    from repro_torch.sketch import sparse as port_sparse

    for module in (ref_sparse, port_sparse):
        monkeypatch.setattr(module, "_FLUSH_MIN_PAIRS", 1 << 10)
    snaps = []
    for pkg, m, backend, extra in ((ref_sketch, ref_metrics, "jnp", {}), (sketch, metrics, "torch",
                                                                           {"device": "cpu"})):
        m.enable()
        rng = np.random.default_rng(3)
        cfg = pkg.HLLConfig(p=8, hash_bits=64)
        hyb = pkg.HybridBank.empty(4, cfg, threshold=4, **extra)
        plan = pkg.ExecutionPlan(backend=backend)
        for _ in range(6):
            hyb = hyb.update_many(rng.integers(0, 4, 3000).astype(np.int32),
                                  rng.integers(0, 2**31, 3000).astype(np.int32), plan)
        hyb.estimate_many(plan=plan)
        snaps.append(m.snapshot())
    theirs, mine = snaps
    assert_snapshots_agree(mine, theirs)
    assert mine["counters"]["sparse.flush.pressure"] >= 1 and mine["counters"]["sparse.promotions"] >= 1


def test_estimate_seams_count_like_reference():
    """The three estimate entry points each book one ``estimate`` seam."""
    snaps = []
    for est_module, m, regs in (
        (ref_sketch.estimators, ref_metrics, lambda x: jnp.asarray(x)),
        (sketch.estimators, metrics, lambda x: torch.from_numpy(x)),
    ):
        m.enable()
        reg = np.random.default_rng(1).integers(0, 20, (5, 64)).astype(np.uint8)
        cfg = (ref_sketch if m is ref_metrics else sketch).HLLConfig(p=6, hash_bits=32)
        est_module.estimate(regs(reg[0]), cfg, "ertl_improved")
        est_module.estimate_device(regs(reg[1]), cfg)
        est_module.estimate_many(regs(reg), cfg, "original")
        snaps.append(m.snapshot())
    theirs, mine = snaps
    assert_snapshots_agree(mine, theirs)
    assert mine["counters"]["dispatch.estimate.ertl_improved.calls"] == 1


# ----------------------------------------------------------------------------
# spans in torch.profiler's trace: each span and sketch-path region is a
# profiler range enclosing its body's ops, and a dispatch seam is none (it
# reaches the metrics and the capture only); no range is entered without a
# profiler or while torch.compile traces
# ----------------------------------------------------------------------------

SKETCH_SPANS = {"sketch.bank.update_many", "sketch.bank.counters", "sketch.bank.estimate_many",
                "sketch.estimate.histogram", "sketch.estimate.finalize", "sketch.update"}
# the seams those sketch calls dispatch through: in the capture, not the profile
SKETCH_SEAMS = {"bank_update[torch]", "estimate[original]", "update[torch]"}
# a count-min tick's ranges, in the order they open, and its backend's seam
CM_SPANS = ("sketch.cm.update_many", "sketch.cm.scatter", "sketch.cm.vote", "sketch.cm.counters")
CM_SEAM = "cm_update[torch]"


def _profiled(body, tmp_path):
    """(annotations, ops) of ``body()`` run under ``torch.profiler`` (host
    activity): [(name, start, end)] of the ``user_annotation`` and the
    ``cpu_op`` events of its exported Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]

    def of(cat):
        return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events if e.get("cat") == cat]

    return of("user_annotation"), of("cpu_op")


def _one(found, name):
    (hit,) = [f for f in found if f[0] == name]
    return hit


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _sketch_calls():
    """A bank tick, its read and a single-sketch update, on the torch backend."""
    bank = _ingest(_empty())
    bank.estimate_many("original")
    sketch.HyperLogLog.empty(CFG, device="cpu").update(torch.arange(32, dtype=torch.int32),
                                                       ExecutionPlan(backend="torch"))


def test_span_and_seam_are_profiler_ranges_around_their_ops(tmp_path):
    """A span is a profiler range around its ops; a seam is a capture event
    and no profiler range."""
    x = torch.arange(64, dtype=torch.float32)
    timed = {}

    def body():
        with tracing.span("obs.body") as t:
            x + 1
        timed["span"] = t
        with metrics.seam("update", "torch"):
            x * 2

    tracing.start_trace()
    notes, ops = _profiled(body, tmp_path)
    captured = [e["name"] for e in tracing.stop_trace()]
    span = _one(notes, "obs.body")
    assert _inside(_one(ops, "aten::add"), span) and not _inside(_one(ops, "aten::mul"), span)
    assert [n[0] for n in notes] == ["obs.body"]
    # what was there stays: the span's wall time, the capture, an empty registry
    assert timed["span"].elapsed_s > 0
    assert captured == ["obs.body", "update[torch]"]
    assert metrics.snapshot()["counters"] == {}


def test_sketch_path_spans_nest_in_the_profile(tmp_path):
    notes, ops = _profiled(_sketch_calls, tmp_path)
    names = {n[0] for n in notes}
    assert SKETCH_SPANS <= names and not SKETCH_SEAMS & names
    tick, counters = _one(notes, "sketch.bank.update_many"), _one(notes, "sketch.bank.counters")
    assert _inside(counters, tick)
    assert any(_inside(op, counters) for op in ops if op[0] == "aten::bincount")
    # the backend's scatter runs in the tick before its counters
    assert any(_inside(op, tick) and op[2] <= counters[1] for op in ops if op[0] == "aten::scatter_reduce_")
    read = _one(notes, "sketch.bank.estimate_many")
    hist, fin = _one(notes, "sketch.estimate.histogram"), _one(notes, "sketch.estimate.finalize")
    assert _inside(hist, read) and _inside(fin, read) and hist[2] <= fin[1]
    assert any(_inside(op, hist) for op in ops if op[0] == "aten::bincount")
    assert any(_inside(op, _one(notes, "sketch.update")) for op in ops)


def _spy_ranges(monkeypatch) -> list:
    """The names of the profiler ranges the obs layer opens from now on."""
    entered, real = [], metrics.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(metrics, "record_function", spy)
    return entered


def test_no_profiler_enters_no_record_function(monkeypatch, tmp_path):
    entered = _spy_ranges(monkeypatch)

    def body():
        with tracing.span("obs.body"):
            pass
        with tracing.region("obs.region"):
            pass
        _sketch_calls()

    body()
    # neither the metrics registry nor a capture opens a profiler range
    metrics.enable()
    tracing.start_trace()
    body()
    tracing.stop_trace()
    metrics.disable()
    assert entered == []
    assert tracing.region("obs.region") is tracing.region("obs.other")  # one shared null context
    _profiled(body, tmp_path)
    assert set(entered) == SKETCH_SPANS | {"obs.body", "obs.region"}


def test_nothing_is_entered_under_compile(monkeypatch):
    """A region and a wrapped backend in a compiled caller open no range,
    in the trace or in the replays.  (A span's ``perf_counter`` breaks the
    graph, so dynamo runs a caller of it as plain Python, which the span
    then times and marks like any other.)"""
    from torch.profiler import ProfilerActivity, profile

    entered = _spy_ranges(monkeypatch)
    wrapped = get_bank_backend("torch")
    plan = ExecutionPlan(backend="torch")
    regs = _empty().registers
    keys = torch.arange(8, dtype=torch.int32) % 4
    items = torch.arange(8, dtype=torch.int32)

    def f(x):
        with tracing.region("compiled.region"):
            return x + 1

    g = torch.compile(f, backend="eager")
    h = torch.compile(lambda r, k, x: wrapped(r, k, x, CFG, plan), backend="eager")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):  # traces, then replays the graph
            g(torch.arange(3))
            h(regs, keys, items)
        assert entered == []
        f(torch.arange(3))  # ...while the same code run eagerly opens each range
        wrapped(regs, keys, items, CFG, plan)
    assert entered == ["compiled.region"]  # a wrapped backend opens none


def test_the_profiler_leaves_the_capture_as_the_reference_has_it(tmp_path):
    """The sketch-path regions reach the profiler only: a capture taken
    under the profiler holds the same events as one taken without it."""
    place = lambda make, *a, **k: make(*a, **k, device="cpu")
    tracing.start_trace()
    _op_sequence(sketch, "torch", place)
    plain = [e["name"] for e in tracing.stop_trace()]
    tracing.start_trace()
    notes, _ = _profiled(lambda: _op_sequence(sketch, "torch", place), tmp_path)
    profiled = [e["name"] for e in tracing.stop_trace()]
    assert profiled == plain
    assert {"sketch.bank.update_many", "sketch.bank.counters"} <= {n[0] for n in notes}


def _cm_tick():
    """A count-min tick on the torch backend, keys -1 and B among them (dropped)."""
    rng = np.random.default_rng(31)
    keys = torch.from_numpy(rng.integers(-1, 5, 600).astype(np.int32))
    items = torch.from_numpy(rng.integers(-20, 20, 600).astype(np.int32))
    bank = sketch.CountMinBank.empty(4, sketch.CMConfig(depth=3, width=64), device="cpu")
    return bank.update_many(keys, items, ExecutionPlan(backend="torch")), (keys, items)


def test_count_min_tick_spans_nest_in_the_profile(tmp_path):
    notes, ops = _profiled(_cm_tick, tmp_path)
    spans = [_one(notes, name) for name in CM_SPANS]
    tick, scatter, vote, counters = spans
    assert all(_inside(inner, tick) for inner in spans[1:])
    assert scatter[2] <= vote[1] and vote[2] <= counters[1]  # in that order, none inside another
    assert CM_SEAM not in {n[0] for n in notes}
    sorts = [op for op in ops if op[0] == "aten::sort"]
    assert sorts and all(_inside(op, vote) for op in sorts)


def test_count_min_ranges_open_only_under_the_profiler(monkeypatch, tmp_path):
    entered = _spy_ranges(monkeypatch)
    _cm_tick()
    metrics.enable()
    tracing.start_trace()
    _cm_tick()
    tracing.stop_trace()
    metrics.disable()
    assert entered == []
    _profiled(_cm_tick, tmp_path)
    assert entered == list(CM_SPANS)


def test_count_min_ranges_leave_the_capture_as_it_was(tmp_path):
    """The count-min regions reach the profiler only: a capture of a tick
    taken under the profiler holds the same events as one taken without it."""
    tracing.start_trace()
    _cm_tick()
    plain = [e["name"] for e in tracing.stop_trace()]
    tracing.start_trace()
    notes, _ = _profiled(_cm_tick, tmp_path)
    profiled = [e["name"] for e in tracing.stop_trace()]
    assert profiled == plain == [CM_SEAM]
    assert set(CM_SPANS) <= {n[0] for n in notes}


def test_count_min_tables_are_bit_identical_with_the_ranges_and_without(tmp_path):
    """A tick's counters, labels, votes and row counts are the same under the
    profiler (every range open), without it, and as the tick's three steps
    called one after another with no range at all."""
    from repro_torch.kernels.bank_count import bank_row_count
    from repro_torch.sketch import countmin

    plain, (keys, items) = _cm_tick()
    ranged = []
    _profiled(lambda: ranged.append(_cm_tick()[0]), tmp_path)
    empty = sketch.CountMinBank.empty(4, plain.cfg, device="cpu")
    plan = ExecutionPlan(backend="torch")
    labels, votes = countmin._label_update(empty.labels, empty.label_counts, keys, items, plain.cfg)
    bare = (countmin.update_cm_counters(empty.counters, keys, items, plain.cfg, plan), labels, votes,
            bank_row_count(empty.n_items, keys))
    for bank in (ranged[0], plain):
        for got, want in zip((bank.counters, bank.labels, bank.label_counts, bank.n_items), bare):
            assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(plain.label_counts.gt(0).sum()) > 0 and plain.counts.sum() == int(((keys >= 0) & (keys < 4)).sum())
