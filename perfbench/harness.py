"""The harness: one cell of BENCHMARK.json from set-up to its result line.

A cell names a configuration and a traffic mix; everything else is found
by name.  The configuration file (``BENCHMARK.json``'s ``file``) names its
``system``, whose driver is ``systems/<system>.py`` (open a state, call the
port, read, hand over the outputs), whose plain reference is
``reference/<system>.py``, whose work bytes are ``metrics/work/<system>.py``
and whose test hooks are ``tests/faults/<system>.py``; the configuration's
small sizes for the CPU tests are ``tests/small/<config>.json``; the mix is
``traffic/<config>.<mix>.json``, read by the one generator in ``pool.py``;
a per-layer metric ``<family>.<part>`` is read by ``metrics/<family>.py``
from the traced window's spans (the harness's and the port's own).  So a
configuration of a new system joins by new files and entries appended to
``BENCHMARK.json`` alone.

A run (``run_cell``):

1. set-up: the pool is drawn on the device from the seed; a state of its
   own takes ``WARM_CALLS`` calls (and reads), which builds every kernel
   and warms every shape of the window; ``setup_s`` runs from the start of
   the process to the first timed call;
2. the window: for ``seconds``, the port is called back to back, call i
   taking batch i % batches of the pool; each pass over the pool is one
   data set, landed into a state the program opens empty at the pass's
   first call (so every pass changes the registers, and the check sees
   late calls); a closed-loop mix reads every estimate to the host after
   each call.  The window ends with a synchronize inside it.  Nothing of
   the harness runs on the device in it;
3. with ``--trace 1``, ``TRACE_SECONDS`` more of the window under the
   profiler, each call and read inside an annotation that the metrics'
   readers find in the trace;
4. the check: once the window has closed and the peak memory is read, the
   reference works the outputs out again from the pool and the number of
   calls: the state the window ended in, the last whole pass before it, and
   every read; each number compared must stay within the configuration's
   ``limits``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from perfbench import pool as poollib
from perfbench import trace as tracelib

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_CALLS = 2
TRACE_SECONDS = 0.5


@dataclass
class Cell:
    workload: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclass
class Record:
    """What a per-layer reader reads: the cell and its traced window."""

    config: dict
    traffic: dict
    trace: Optional[tracelib.Trace]


def forbidden_modules(names) -> list:
    """The module names whose top-level package is JAX's or the JAX package's."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_cell(workload: str, benchmark: Path = ROOT / "BENCHMARK.json", overrides: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``benchmark``, its configuration and mix
    read from their files (``overrides`` replaces keys of either: the
    tests' small sizes)."""
    spec = json.loads(Path(benchmark).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark}; known: {sorted(cells)}")
    cell = cells[workload]
    (entry,) = [c for c in spec["configs"] if c["name"] == cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((PACKAGE / "traffic" / f"{cell['config']}.{cell['traffic']}.json").read_text())
    config.update((overrides or {}).get("config", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    end_to_end = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload]) and m["moves"] in reported]
    return Cell(workload, int(cell["chips"]), config, traffic, end_to_end, per_layer)


def metric_path(name: str) -> Path:
    """The reader of metric ``<family>.<part>``: ``metrics/<family>.py``."""
    path = PACKAGE / "metrics" / f"{name.split('.', 1)[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} under {PACKAGE / 'metrics'}")
    return path


def metric_reader(name: str):
    """The ``read(record)`` function of metric ``name``."""
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.reader_{name.replace('.', '_')}",
                                                  metric_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _annotated(name: str, fn):
    """``fn`` inside a profiler annotation ``name``."""
    from torch.profiler import record_function

    def wrapped(*args):
        with record_function(name):
            return fn(*args)

    return wrapped


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Driver:
    """Calls the port back to back, a pass of the pool to a state; counts
    calls, keeps the last whole pass's state and every read."""

    system: object
    config: dict
    batches: list
    read_each_call: bool
    device: torch.device
    state: object = None
    done: object = None
    calls: int = 0
    reads: list = field(default_factory=list)
    latency_ns: list = field(default_factory=list)

    def run(self, seconds: float, annotate: bool = False) -> None:
        """Calls until ``seconds`` have passed (at least one); ``annotate``
        marks each call and read for the profiler and keeps no latency."""
        system, config, device = self.system, self.config, self.device
        call, read = system.call, system.read
        if annotate:
            call, read = _annotated("perfbench.call", call), _annotated("perfbench.read", read)
        batches, n, state, i = self.batches, len(self.batches), self.state, self.calls
        clock, ns = time.perf_counter, time.perf_counter_ns
        deadline = clock() + seconds
        while True:
            if i % n == 0:
                if i:
                    self.done = state
                state = system.open_state(config, device)
            t0 = ns()
            state = call(state, batches[i % n])
            i += 1
            if self.read_each_call:
                self.reads.append(read(state, config))
                if not annotate:
                    self.latency_ns.append(ns() - t0)
            if clock() >= deadline:
                break
        self.state, self.calls = state, i


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its limit."""
    checks = {}
    for name, value in numbers.items():
        if name not in limits:
            raise KeyError(f"the configuration states no limit for {name!r}")
        checks[name] = {"value": value, "limit": limits[name]}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def _device_info(device: torch.device, chips: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": device.type, "kind": device.type, "count": chips, "memory_peak_bytes": peak}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
             control: bool = False) -> dict:
    """One run of ``cell``; the result line's object.  ``control`` adds the
    control's numbers under ``"control"`` (the readings that set a limit;
    a benchmark run never computes them)."""
    config, traffic = cell.config, cell.traffic
    system = importlib.import_module(f"perfbench.systems.{config['system']}")
    reference = importlib.import_module(f"perfbench.reference.{config['system']}")
    batches = poollib.make(config, traffic, seed, device)
    read_each_call = bool(traffic.get("read_each_call", False))

    warm = system.open_state(config, device)
    for batch in batches[:WARM_CALLS]:
        warm = system.call(warm, batch)
        if read_each_call:
            system.read(warm, config)
    _sync(device)
    del warm
    driver = Driver(system, config, batches, read_each_call, device)
    # what set-up left stays out of the collector's later passes, so that no
    # pass over the interpreter's whole heap falls inside the window
    gc.collect()
    gc.freeze()
    _sync(device)

    start = time.perf_counter()
    driver.run(seconds)
    _sync(device)
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    window_calls = driver.calls
    values = {
        "setup_s": start - t0,
        "items_per_s": window_calls * int(traffic["call_items"]) / window_s,
        "visible_p95_ms": float(np.percentile(driver.latency_ns, 95)) / 1e6 if driver.latency_ns else None,
    }
    info = _device_info(device, cell.chips, peak)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}, "device": info}
    if not trace:
        for m in cell.end_to_end:
            if values.get(m["name"]) is None:
                raise ValueError(f"workload {cell.workload} does not give {m['name']}")
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        traced = tracelib.profiled(lambda: driver.run(TRACE_SECONDS, annotate=True), device)
        record = Record(config, traffic, traced)
        for m in cell.per_layer:
            value = metric_reader(m["name"])(record)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"], info["window_s"] = traced.busy_s, traced.window_s
        result["breakdown"] = {"device_ops": traced.device_ops, "idle_gaps": traced.idle_gaps}

    gc.unfreeze()
    calls = driver.calls
    got = {"now": system.outputs(driver.state)}
    if driver.done is not None:
        got["pass"] = system.outputs(driver.done)
    reads = torch.stack(driver.reads).numpy() if driver.reads else None
    del driver
    if reads is not None:
        got["reads"] = reads
    n_reads = 0 if reads is None else len(reads)
    want = reference.expected(config, batches, calls, reads=n_reads)
    correct, checks = judge(reference.compare(got, want), config["limits"])
    result.update(correct=correct, attempted=calls, failed=0 if correct else calls)
    if control:
        low = reference.expected(config, batches, calls, reads=n_reads, precision="low")
        result["control"] = reference.compare(low, want)
    result["checks"] = checks
    return result


def check_lines(result: dict) -> list:
    """Each number compared beside its limit, one plain line each."""
    return [f"check {name} = {c['value']!r} (limit {c['limit']!r})" for name, c in result["checks"].items()]
