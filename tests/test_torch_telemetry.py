"""Port vs reference: the StreamSketch telemetry board.

The port's board runs under the port's default plan ("cuda", plain
versions on the CPU) and under "torch"; the reference's under its default
plan ("jnp").  Every test feeds both the same seeded numpy streams.

* Flat, windowed and multi-resolution boards: ``report(exact=True)``
  equal, ``report()``'s device estimates within rtol 1e-6 (the bound of
  tests/test_torch_estimators.py), ``serialize()`` / ``window_bytes()``
  and ``density()`` equal.
* ``track_topk`` on flat and windowed boards: ``topk(name, k)`` for every
  stream and ``report(topk=k)`` equal.
* Buffered versus unbuffered ingest, the auto-flush threshold,
  ``merge_from``, ``deserialize``, the guards, and the fallback for a
  plugin backend without a bank or count-min path.

* The reference's two MoE collapse tests (tests/test_telemetry.py) on the
  port's ``moe.assignment_stream`` and board, with the packing and the
  boards' reports held to the reference's as well.

The reference's windowed boards call ``jax.core.trace_state_clean``, which jax
0.9.0 moved; an autouse fixture aliases it back (ROADMAP §C).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as ref_moe
from repro.sketch import CMConfig as RefCMConfig
from repro.sketch.hll import HLLConfig as RefConfig
from repro.telemetry.sketchboard import StreamSketch as RefBoard
from repro_torch.configs import get_arch
from repro_torch.models import moe as moe_lib
from repro_torch.sketch import plan as plan_registry
from repro_torch.sketch import CMConfig, ExecutionPlan, HLLConfig, HyperLogLog
from repro_torch.telemetry import StreamSketch

DEVICE_RTOL = 1e-6  # the estimator bound (tests/test_torch_estimators.py)
PORT_PLANS = (None, "torch")  # None: the port's DEFAULT_PLAN ("cuda")
P, H = 8, 64
CM = (2, 64, 3)  # depth, width, seed


@pytest.fixture(autouse=True)
def _trace_state_alias(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)


def _boards(backend, topk=False, **kw):
    plan = None if backend is None else ExecutionPlan(backend=backend)
    port = StreamSketch(HLLConfig(p=P, hash_bits=H), plan=plan, device="cpu",
                        track_topk=CMConfig(*CM) if topk else None, **kw)
    ref = RefBoard(RefConfig(p=P, hash_bits=H), track_topk=RefCMConfig(*CM) if topk else None, **kw)
    return port, ref


def _epoch(rng, streams=5, n=3000):
    """One epoch split over the streams by Zipf(1.2), Zipf(1.1) items."""
    which = (rng.zipf(1.2, n) - 1) % streams
    items = (rng.zipf(1.1, n) % 500).astype(np.int32)
    items[:2] = [-1, 2**31 - 1]
    return {f"s{i}": items[which == i] for i in range(streams) if (which == i).any()}


def _feed(board, chunks, ref=False):
    for name, items in chunks.items():
        board.observe(name, jnp.asarray(items) if ref else items)


def _same_report(port, ref, **kw):
    got, want = port.report(**kw), ref.report(**kw)
    assert list(got) == list(want)
    for name in want:
        for col in ("items_seen", "stderr_expected", "topk"):
            assert got[name].get(col) == want[name].get(col), (name, col)
        np.testing.assert_allclose(got[name]["estimate"], want[name]["estimate"], rtol=DEVICE_RTOL)
    exact_got, exact_want = port.report(exact=True), ref.report(exact=True)
    assert list(exact_got) == list(exact_want)
    for name in exact_want:
        for col in ("estimate", "items_seen", "stderr_expected"):
            assert exact_got[name][col] == exact_want[name][col], (name, col)
    assert port.density() == ref.density()


@pytest.mark.parametrize("backend", PORT_PLANS)
def test_flat_board_matches_reference(backend):
    port, ref = _boards(backend, flush_items=4000)
    rng = np.random.default_rng(1)
    for _ in range(4):
        chunks = _epoch(rng)
        _feed(port, chunks)
        _feed(ref, chunks, ref=True)
        assert port._pending_items == ref._pending_items
    _same_report(port, ref)
    assert port.serialize() == ref.serialize()
    for name in ref.sketches:
        assert port.estimate(name) == ref.estimate(name)
        assert port.stream(name).to_bytes() == ref.stream(name).to_bytes()


@pytest.mark.parametrize("backend", PORT_PLANS)
def test_windowed_board_matches_reference(backend):
    port, ref = _boards(backend, window=3)
    rng = np.random.default_rng(2)
    for step in range(7):
        chunks = _epoch(rng)
        _feed(port, chunks)
        _feed(ref, chunks, ref=True)
        _same_report(port, ref)
        assert port.window_bytes() == ref.window_bytes()
        assert port.window_rows() == ref.window_rows()
        if step == 4:
            port.advance_to(port._wbank.epoch + 5)  # a jump past W expires everything
            ref.advance_to(int(ref._wbank.epoch) + 5)
        else:
            port.advance()
            ref.advance()
    for name in ref.window_rows():
        assert port.estimate(name) == ref.estimate(name)


def test_multires_board_matches_reference():
    port, ref = _boards("torch", window=2, window_levels=2)
    rng = np.random.default_rng(3)
    for _ in range(6):
        chunks = _epoch(rng)
        _feed(port, chunks)
        _feed(ref, chunks, ref=True)
        _same_report(port, ref)
        assert port.window_bytes() == ref.window_bytes()
        port.advance()
        ref.advance()


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("backend", PORT_PLANS)
def test_topk_board_matches_reference(backend, window):
    port, ref = _boards(backend, topk=True, window=window, flush_items=5000)
    rng = np.random.default_rng(4)
    for step in range(5):
        chunks = _epoch(rng, streams=6)
        _feed(port, chunks)
        _feed(ref, chunks, ref=True)
        names = list(ref.window_rows() if window else ref.sketches)
        for name in names + ["never-seen"]:
            assert port.topk(name, 5) == ref.topk(name, 5), name
        _same_report(port, ref, topk=3)
        if window:
            port.advance()
            ref.advance()
    if window:
        assert port.window_bytes() == ref.window_bytes()
    else:
        assert port.serialize() == ref.serialize()
        assert port._cmbank.to_bytes() == ref._cmbank.to_bytes()


def test_buffered_ingest_matches_unbuffered_per_stream_updates():
    cfg = HLLConfig(p=10, hash_bits=64)
    board = StreamSketch(cfg, device="cpu", flush_items=1 << 30)
    unbuffered = StreamSketch(cfg, device="cpu", flush_items=1)
    rng = np.random.default_rng(3)
    chunks = {
        "a": [rng.integers(0, 10_000, 5_000, np.int32) for _ in range(3)],
        "b": [rng.integers(0, 300, 2_000, np.int32) for _ in range(2)],
        "c": [rng.integers(0, 2**31, 4_099, np.int32)],
    }
    for name, arrays in chunks.items():
        for a in arrays:
            board.observe(name, a)
            unbuffered.observe(name, a)
    assert board._pending_items == sum(a.size for arrays in chunks.values() for a in arrays)
    assert unbuffered._pending_items == 0
    board.flush()
    assert board._pending_items == 0
    for name, arrays in chunks.items():
        direct = HyperLogLog.empty(cfg, "cpu")
        for a in arrays:
            direct = direct.update(a)
        for got in (board.stream(name), unbuffered.stream(name)):
            torch.testing.assert_close(got.registers, direct.registers, rtol=0, atol=0)
            assert got.count == direct.count


def test_auto_flush_threshold_and_read_paths_flush():
    board = StreamSketch(HLLConfig(p=10, hash_bits=64), flush_items=100, device="cpu")
    board.observe("s", np.arange(200, dtype=np.int32))  # crosses the threshold
    assert board._pending_items == 0
    board.observe("s", np.arange(200, 230, dtype=np.int32))
    assert board._pending_items == 30
    assert board.report()["s"]["items_seen"] == 230 and board._pending_items == 0
    board.observe("s", np.arange(230, 250, dtype=np.int32))
    assert board.stream("s").count == 250
    board.observe("t", np.arange(5, dtype=np.int32))
    blobs = board.serialize()
    assert board._pending_items == 0
    assert StreamSketch.deserialize(blobs, device="cpu").report()["t"]["items_seen"] == 5


@pytest.mark.parametrize("topk", [False, True])
def test_merge_from_matches_reference(topk):
    rng = np.random.default_rng(5)
    (a, ra), (b, rb) = _boards("torch", topk=topk), _boards("torch", topk=topk)
    chunks_a, chunks_b = _epoch(rng, streams=4), _epoch(rng, streams=6)
    _feed(a, chunks_a)
    _feed(ra, chunks_a, ref=True)
    _feed(b, chunks_b)
    _feed(rb, chunks_b, ref=True)
    a.merge_from(b)  # both still buffered: merge_from flushes both
    ra.merge_from(rb)
    assert a.serialize() == ra.serialize()
    _same_report(a, ra, topk=4 if topk else None)
    if topk:
        assert a._cmbank.to_bytes() == ra._cmbank.to_bytes()


def test_deserialize_and_guards():
    cfg = HLLConfig(p=10, hash_bits=64)
    board = StreamSketch(cfg, device="cpu")
    assert not StreamSketch.deserialize(board.serialize(), cfg=cfg, device="cpu").sketches
    board.observe("s", np.arange(100, dtype=np.int32))
    blobs = board.serialize()
    with pytest.raises(ValueError, match="cfg mismatch"):
        StreamSketch.deserialize(blobs, cfg=HLLConfig(p=12, hash_bits=64), device="cpu")
    with pytest.raises(ValueError, match="pass cfg"):
        StreamSketch.deserialize({}, device="cpu")
    assert StreamSketch.deserialize(blobs, device="cpu").estimate("s") == board.estimate("s")
    with pytest.raises(ValueError, match="different configs"):
        board.merge_from(StreamSketch(HLLConfig(p=12, hash_bits=64), device="cpu"))
    with pytest.raises(ValueError, match="track_topk"):
        board.merge_from(StreamSketch(cfg, device="cpu", track_topk=CMConfig()))
    with pytest.raises(ValueError, match="heavy-hitter board"):
        board.topk("s")
    with pytest.raises(ValueError, match="windowed board"):
        board.advance()
    windowed = StreamSketch(cfg, device="cpu", window=2)
    with pytest.raises(ValueError, match="do not merge"):
        board.merge_from(windowed)
    with pytest.raises(ValueError, match="use window_bytes"):
        windowed.serialize()
    with pytest.raises(ValueError, match="cannot combine with track_topk"):
        StreamSketch(cfg, device="cpu", window=4, window_levels=2, track_topk=CMConfig())
    with pytest.raises(ValueError, match="needs a windowed board"):
        StreamSketch(cfg, device="cpu", window_levels=2)
    with pytest.raises(ValueError, match="at least one bucket"):
        StreamSketch(cfg, device="cpu", window=0)


def test_board_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamSketch(HLLConfig())


def test_plugin_backend_without_bank_or_cm_path_still_ingests(monkeypatch):
    # registered through monkeypatch so the registries are restored afterwards
    monkeypatch.setitem(plan_registry._BACKENDS, "single_only", plan_registry.get_backend("torch"))
    port, ref = _boards("torch", topk=True)
    plugin = StreamSketch(HLLConfig(p=P, hash_bits=H), plan=ExecutionPlan(backend="single_only"),
                          device="cpu", track_topk=CMConfig(*CM))
    assert plugin._cm_plan() is None and port._cm_plan() is not None
    chunks = _epoch(np.random.default_rng(6))
    for board in (plugin, port):
        _feed(board, chunks)
    assert plugin.serialize() == port.serialize()
    for name in chunks:
        assert plugin.topk(name, 4) == port.topk(name, 4)


def test_moe_assignment_stream_detects_collapse():
    """Distinct (token,expert) pairs drop when the router collapses."""
    cfg = HLLConfig(p=12, hash_bits=64)
    arch = get_arch("olmoe-1b-7b").reduced()
    rng = np.random.default_rng(1)
    B, S, k = 4, 64, arch.moe.top_k
    tokens = rng.integers(0, 400, (B, S), np.int32)
    healthy = rng.integers(0, arch.moe.num_experts, (B, S, k), np.int32)
    collapsed = np.zeros((B, S, k), np.int32)  # everything -> expert 0

    board = StreamSketch(cfg, device="cpu")
    ref = RefBoard(RefConfig(p=12, hash_bits=64))
    for name, experts in (("healthy", healthy), ("collapsed", collapsed)):
        board.observe(name, moe_lib.assignment_stream(torch.from_numpy(tokens), torch.from_numpy(experts)))
        ref.observe(name, ref_moe.assignment_stream(jnp.asarray(tokens), jnp.asarray(experts)))
    rep = board.report()
    assert rep["healthy"]["estimate"] > 1.5 * rep["collapsed"]["estimate"]
    assert board.report(exact=True) == ref.report(exact=True)


def test_assignment_stream_packing():
    pairs = moe_lib.assignment_stream(torch.tensor([[1, 2]], dtype=torch.int32),
                                      torch.tensor([[[3, 4], [5, 6]]], dtype=torch.int32))
    assert pairs.dtype == torch.int32
    np.testing.assert_array_equal(pairs.numpy(), [(1 << 8) | 3, (1 << 8) | 4, (2 << 8) | 5, (2 << 8) | 6])
    # bit-identical to the reference's over the token ids of the largest
    # vocabulary and every expert index, int64 indices as the port's router
    # returns them included
    rng = np.random.default_rng(2)
    vocab = max(ref_configs.get_arch(a).vocab_size for a in ref_configs.ARCH_IDS)
    tokens = rng.integers(0, vocab, (3, 50), np.int32)
    experts = rng.integers(0, 64, (3, 50, 8), np.int32)
    want = np.asarray(ref_moe.assignment_stream(jnp.asarray(tokens), jnp.asarray(experts)))
    for idx in (torch.from_numpy(experts), torch.from_numpy(experts).long()):
        np.testing.assert_array_equal(moe_lib.assignment_stream(torch.from_numpy(tokens), idx).numpy(), want)
