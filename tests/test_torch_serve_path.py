"""Port vs reference: the coalescing serve path and the serve launcher.

* coalescer -- N interleaved per-tenant submits drained as one merged
  batch land bit for bit as per-batch ingest, and as the reference's
  carriers fed the same batches (registers, counts, modes); the queue's
  edge semantics; the staging ring's rotation, which keeps each slot's
  host sources and device tensors alive; shared window rings.
* serve-loop pins -- zero-elapsed spans format instead of raising, empty
  decode slices do not expire the prompt epoch at W > T, ``--report-every
  0`` prints no ``[metrics]`` line, ``--placement sharded`` runs, and so
  does the MoE family (mixtral-8x7b), once refused.
* the launcher end to end against the reference's on the CPU, reduced
  RWKV6-3B, at ``--window-levels`` 0 and 2: the port gets the reference's
  weights (``interop.model_from_reference``) and prompts, and its decode
  returns the reference's tokens (a bf16 RWKV6 can flip a greedy token,
  ROADMAP C).  Every printed line is identical but the tok/s line and the
  latencies in ``[metrics]`` lines, and the snapshots agree as in
  ``tests/test_torch_obs.py``: the reference's default backend ``jnp``
  named as the port's default ``cuda`` (on the CPU the port's kernel
  wrappers run their plain versions).
"""

import contextlib
import io
import json
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve
from repro.obs import metrics as ref_metrics
from repro.obs import tracing as ref_tracing
from repro.serve.coalesce import CoalescingQueue as RefQueue
from repro.serve.coalesce import SharedWindowRing as RefSharedRing
from repro.sketch import HLLConfig as RefConfig
from repro.sketch import HybridBank as RefHybrid
from repro.sketch import SketchBank as RefBank
from repro_torch import interop
from repro_torch.launch import serve
from repro_torch.obs import metrics, tracing
from repro_torch.obs.format import fmt_count, fmt_rate, per_second
from repro_torch.serve.coalesce import CoalescingQueue, DoubleBuffer, SharedWindowRing
from repro_torch.sketch import HLLConfig, HybridBank, SketchBank, WindowedBank

from test_torch_obs import assert_snapshots_agree  # tests/ is on the path, as pytest runs it

CFG = HLLConfig(p=8, hash_bits=64)
RCFG = RefConfig(p=8, hash_bits=64)
# the reference's default plan runs "jnp", the port's "cuda"
DEFAULTS = {"jnp": "cuda"}
LAUNCH = ["--arch", "rwkv6-3b", "--requests", "4", "--prompt-len", "16", "--gen-len", "2",
          "--window-epochs", "4"]


def _clean():
    for m, t in ((metrics, tracing), (ref_metrics, ref_tracing)):
        m.disable()
        m.reset()
        if t.active():
            t.stop_trace()
    SharedWindowRing.reset()
    RefSharedRing.reset()


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """Metrics off and empty, no trace and no shared ring, in both packages,
    before and after every test; the reference's windows and enabled
    metrics need ``jax.core.trace_state_clean`` (ROADMAP C)."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    _clean()
    yield
    _clean()


def _batches(rng, rows, lengths, hi=1 << 20):
    return [
        (rng.integers(0, rows, n).astype(np.int32), rng.integers(0, hi, n).astype(np.int32))
        for n in lengths
    ]


# ----------------------------------------------------------------------------
# coalescer: merged ticks are pure batching
# ----------------------------------------------------------------------------


def test_coalesced_tick_matches_per_batch_ingest_bit_for_bit():
    """N interleaved tenant submits == one merged update_many == the
    reference's bank fed the same batches."""
    rng = np.random.default_rng(1)
    rows = 16
    batches = _batches(rng, rows, (5, 1, 33, 17, 8))
    ref = SketchBank.empty(rows, CFG, device="cpu")
    theirs = RefBank.empty(rows, RCFG)
    for keys, items in batches:
        ref = ref.update_many(keys, items)
        theirs = theirs.update_many(keys, items)

    queue = CoalescingQueue(device="cpu")
    for keys, items in batches:
        queue.submit(keys, items)
    assert queue.pending_batches() == len(batches)
    assert queue.pending_items() == sum(k.shape[0] for k, _ in batches)
    got = queue.flush_into(SketchBank.empty(rows, CFG, device="cpu"))
    assert queue.pending_batches() == 0

    assert torch.equal(ref.registers, got.registers)
    np.testing.assert_array_equal(ref.counts, got.counts)
    np.testing.assert_array_equal(got.registers.numpy(), np.asarray(theirs.registers))
    np.testing.assert_array_equal(got.counts, theirs.counts)


def test_coalescer_host_routes_hybrid_carrier():
    """HybridBank ingests the merged batch on host (append-log path)."""
    rng = np.random.default_rng(2)
    rows = 8
    keys = rng.integers(0, rows, 64).astype(np.int32)
    items = rng.integers(0, 50, 64).astype(np.int32)
    ref = HybridBank.empty(rows, CFG, threshold=4, device="cpu").update_many(keys, items)
    theirs = RefHybrid.empty(rows, RCFG, threshold=4).update_many(keys, items).compact()

    queue = CoalescingQueue(device="cpu")
    queue.submit(keys[:40], items[:40])
    queue.submit(keys[40:], items[40:])
    got = queue.flush_into(HybridBank.empty(rows, CFG, threshold=4, device="cpu"))

    ref, got = ref.compact(), got.compact()
    assert torch.equal(ref.to_dense().registers, got.to_dense().registers)
    np.testing.assert_array_equal(ref.counts, got.counts)
    np.testing.assert_array_equal(ref.modes, got.modes)
    np.testing.assert_array_equal(got.to_dense().registers.numpy(), np.asarray(theirs.to_dense().registers))
    np.testing.assert_array_equal(got.counts, theirs.counts)
    np.testing.assert_array_equal(np.asarray(got.modes), np.asarray(theirs.modes))
    assert got.to_bytes() == theirs.to_bytes()


def test_coalescer_edge_semantics():
    queue = CoalescingQueue(device="cpu")
    assert queue.drain() is None  # a tick with no traffic dispatches nothing
    bank = SketchBank.empty(4, CFG, device="cpu")
    assert queue.flush_into(bank) is bank
    with pytest.raises(ValueError, match="same length"):
        queue.submit(np.arange(3), np.arange(4))
    assert queue.submit(np.empty(0, np.int32), np.empty(0, np.int32)) == 0
    assert queue.pending_batches() == 0  # empty submits are not queued
    queue.submit_row(2, np.arange(5))
    keys, items = queue.drain(stage=False)
    np.testing.assert_array_equal(keys, np.full(5, 2, np.int32))
    np.testing.assert_array_equal(items, np.arange(5))


def test_coalescer_counts_its_ticks_like_reference():
    rng = np.random.default_rng(4)
    batches = _batches(rng, 6, (7, 0, 12, 3))
    snaps = []
    for m, queue, bank in ((ref_metrics, RefQueue(), RefBank.empty(6, RCFG)),
                           (metrics, CoalescingQueue(device="cpu"), SketchBank.empty(6, CFG, device="cpu"))):
        m.enable()
        for keys, items in batches[:2]:
            queue.submit(keys, items)
        bank = queue.flush_into(bank)
        queue.flush_into(bank)  # nothing pending: no tick
        for keys, items in batches[2:]:
            queue.submit(keys, items)
        queue.submit_row(5, np.arange(9))
        queue.flush_into(bank)
        snaps.append(m.snapshot())
    theirs, mine = snaps
    assert_snapshots_agree(mine, theirs, DEFAULTS)
    assert mine["counters"]["serve.coalesce.ticks"] == 2 and mine["counters"]["serve.coalesce.submitted"] == 4


def test_double_buffer_rotates_and_pins_in_flight_slots():
    buf = DoubleBuffer(device="cpu")
    assert buf.depth == 2
    with pytest.raises(ValueError, match="2 slots"):
        DoubleBuffer(depth=1, device="cpu")
    src = np.arange(4)
    a = buf.stage(src)
    b = buf.stage(np.arange(8))
    # both in-flight batches stay referenced by the ring, their host
    # sources with them; the third stage overwrites the oldest slot only
    assert buf._slots[0].tensors is a and buf._slots[1].tensors is b
    assert all(isinstance(s, torch.Tensor) for s in buf._slots[0].sources)
    c = buf.stage(np.arange(2))
    assert buf._slots[0].tensors is c and buf._slots[1].tensors is b
    np.testing.assert_array_equal(c[0].numpy(), np.arange(2))
    assert isinstance(c[0], torch.Tensor) and c[0].device.type == "cpu"
    # on the CPU staging is a copy: the staged tensor does not alias the array
    src[0] = 99
    assert int(a[0][0]) == 0


def test_shared_window_ring_reuses_and_swaps():
    key = ("test", 0, 2, 4, CFG)
    built = []
    factory = lambda: built.append(1) or WindowedBank.empty(2, 4, CFG, device="cpu")
    ring = SharedWindowRing.get_or_create(key, factory)
    again = SharedWindowRing.get_or_create(key, factory)
    assert again is ring and built == [1]  # factory ran exactly once
    advanced = ring.advance()
    assert SharedWindowRing.swap(key, advanced) is advanced
    assert SharedWindowRing.get_or_create(key, factory) is advanced
    assert built == [1]
    SharedWindowRing.reset()
    assert SharedWindowRing.get_or_create(key, factory) is not advanced and built == [1, 1]


# ----------------------------------------------------------------------------
# serve-loop pins
# ----------------------------------------------------------------------------


def test_zero_elapsed_span_formats_instead_of_raising(monkeypatch):
    """A span quantized to 0.0s must yield a printable rate, not a crash."""
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: 1234.5)
    with tracing.span("serve.prefill") as t:
        pass
    assert t.elapsed_s == 0.0
    # the exact serve.py report seam: fmt_rate(per_second(work, elapsed))
    assert fmt_rate(per_second(2048, t.elapsed_s), "tok") == "inf tok/s"
    assert per_second(0, t.elapsed_s) == 0.0
    assert per_second(-0.0, 0.0) == 0.0
    assert fmt_count(float("inf")) == "inf"
    assert fmt_count(float("-inf")) == "-inf"
    assert fmt_count(float("nan")) == "nan"


def test_empty_decode_slices_do_not_expire_prompt_epoch():
    """W > T: the split's token-less tail slices must not advance (the
    launcher's guard, on ``torch.tensor_split`` as it runs there)."""
    W, B, S, T = 6, 3, 40, 2  # W > T: 4 of the 6 slices are empty
    rng = np.random.default_rng(3)
    # disjoint value ranges so prompt-vs-decode attribution is exact
    prompts = torch.from_numpy(rng.integers(1 << 10, 1 << 20, (B, S)).astype(np.int32))
    out = torch.from_numpy(rng.integers(0, 8, (B, T)).astype(np.int32))
    rows = torch.arange(B, dtype=torch.int32)[:, None]
    sizes = [c.shape[1] for c in torch.tensor_split(out, W, dim=1)]
    assert sizes == [a.shape[1] for a in np.array_split(out.numpy(), W, axis=1)]

    win = WindowedBank.empty(W, B, CFG, device="cpu").observe(rows.expand(B, S), prompts)
    advances = 0
    for chunk in torch.tensor_split(out, W, dim=1):
        if chunk.shape[1] == 0:
            continue  # the launcher's guard under test
        win = win.advance()
        advances += 1
        win = win.observe(rows.expand(chunk.shape), chunk)
    assert advances == T  # only REAL decode slices rotate the ring
    # prompt epoch alive: rolling window still counts the prompt tokens
    rolling = win.estimate_window().numpy()
    floor = 0.5 * S  # far above anything T <= 2 decode tokens can explain
    assert (rolling > floor).all(), rolling
    # regression shape: advancing on every split slice expires the prompt
    bad = WindowedBank.empty(W, B, CFG, device="cpu").observe(rows.expand(B, S), prompts)
    for chunk in torch.tensor_split(out, W, dim=1):
        bad = bad.advance()
        if chunk.shape[1]:
            bad = bad.observe(rows.expand(chunk.shape), chunk)
    assert (bad.estimate_window().numpy() < floor).all()


def _run_port(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue()


def test_serve_launcher_report_every_zero_prints_no_metrics_line(tmp_path):
    """--report-every 0 emits no periodic [metrics] line while still
    writing the exit snapshot."""
    path = tmp_path / "metrics.json"
    out = _run_port(LAUNCH + ["--device", "cpu", "--report-every", "0", "--metrics-out", str(path)])
    assert "[metrics]" not in out  # report-every 0: exit-only
    snap = json.loads(path.read_text())
    assert snap["counters"]["serve.coalesce.ticks"] >= 1
    assert snap["counters"]["serve.coalesce.submitted"] >= 4
    assert snap["histograms"]["serve.request.seconds"]["count"] == 4
    # and without --metrics-out the registry stays off and empty
    metrics.disable()
    metrics.reset()
    out = _run_port(LAUNCH + ["--device", "cpu"])
    assert "[metrics]" not in out and not metrics.enabled() and metrics.snapshot()["counters"] == {}


def test_serve_launcher_refuses_sharded_placement_and_unported_families():
    # sharded placement is ported (tests/test_torch_placement.py holds it to local)
    assert "distinct tokens/request" in _run_port(LAUNCH + ["--device", "cpu", "--placement", "sharded"])
    # so is every family (tests/test_torch_families.py holds MoE and the
    # hybrid to the reference launcher)
    out = _run_port(["--device", "cpu", "--arch", "mixtral-8x7b", "--requests", "1", "--prompt-len", "4",
                     "--gen-len", "1"])
    assert out.startswith("mixtral-8x7b: prefill ") and "distinct tokens/request" in out


def _without_wall_times(text: str) -> list:
    """The printed lines, less the tok/s line and the [metrics] latencies."""
    lines = [line for line in text.splitlines() if not line.startswith("rwkv6-3b: prefill ")]
    return [re.sub(r"req p50=\S+ p99=\S+ ", "req p50=* p99=* ", line) for line in lines]


@pytest.mark.parametrize("levels", [0, 2])
def test_serve_launcher_end_to_end_matches_reference(levels, tmp_path, monkeypatch):
    path = tmp_path / "metrics.json"
    argv = LAUNCH + ["--window-levels", str(levels), "--report-every", "2", "--metrics-out", str(path)]
    seen = {}
    ref_init, ref_loop = ref_serve.transformer.init_params, ref_serve.engine.decode_loop

    def spy_init(key, arch):
        seen["params"] = ref_init(key, arch)
        return seen["params"]

    def spy_loop(*args, **kwargs):
        out = ref_loop(*args, **kwargs)
        seen["tokens"] = np.asarray(out[0])
        return out

    monkeypatch.setattr(ref_serve.transformer, "init_params", spy_init)
    monkeypatch.setattr(ref_serve.engine, "decode_loop", spy_loop)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_serve.main()
    theirs_out, theirs = buf.getvalue(), json.loads(path.read_text())
    ref_metrics.disable()
    ref_metrics.reset()

    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 512)).astype(np.int32)
    params = jax.tree_util.tree_map(np.asarray, seen["params"])
    monkeypatch.setattr(serve, "_model", lambda args, arch, device: interop.model_from_reference(params, arch,
                                                                                                  device))
    monkeypatch.setattr(serve, "_prompts", lambda args, arch, device: torch.from_numpy(prompts).to(device))
    port_loop = serve.engine.decode_loop
    # the port's own decode runs; its tokens are pinned to the reference's
    monkeypatch.setattr(serve.engine, "decode_loop", lambda *a, **k: (
        torch.from_numpy(seen["tokens"].copy()), port_loop(*a, **k)[1]))
    mine_out = _run_port(argv + ["--device", "cpu"])
    mine = json.loads(path.read_text())

    assert _without_wall_times(mine_out) == _without_wall_times(theirs_out)
    assert mine_out.count("[metrics]") == 2 and "rwkv6-3b: prefill " in mine_out
    assert_snapshots_agree(mine, theirs, DEFAULTS)
    assert mine["counters"]["window.fold_cache.hits"] == 4


@pytest.mark.gpu
def test_serve_launcher_on_card_dispatches_only_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path = tmp_path / "metrics.json"
    tracing.start_trace()
    _run_port(LAUNCH + ["--device", "cuda", "--metrics-out", str(path)])
    events = {e["name"] for e in tracing.stop_trace()}
    snap = json.loads(path.read_text())
    backends = {k.split(".")[2] for k in snap["counters"]
                if k.startswith("dispatch.") and k.endswith(".calls") and not k.startswith("dispatch.estimate.")}
    assert backends == {"cuda"}, snap["counters"]
    assert {"serve.prefill", "serve.decode", "serve.request", "bank_update[cuda]"} <= events
    queue = CoalescingQueue(device="cuda")
    queue.submit_row(1, np.arange(5, dtype=np.int32))
    keys, items = queue.drain()
    assert keys.device.type == "cuda" and queue._staging._slots[0].sources[0].is_pinned()
    assert keys.tolist() == [1] * 5 and items.tolist() == list(range(5))
