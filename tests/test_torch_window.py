"""Port vs reference: the windowed rings (WindowedBank, HybridWindowedBank,
MultiResWindowedBank) and their RHLW v1-v3 wire formats.

* One seeded walk of observe / advance / advance_to (jumps of W and more
  included) through the port under ``torch``, ``cuda`` and
  ``cuda_pipelined`` (plain versions on the CPU) and through the
  reference's ``jnp`` plan: registers, counters, epochs, cursor, folds and
  bytes bit-identical after every step; host estimates of the folded
  banks equal; device estimates within rtol 1e-6 (the bound of
  tests/test_torch_estimators.py).
* The incremental full-window read (§14) equals a cold masked fold of the
  ring after every rotation, across two wraps of the ring.
* RHLW bytes cross in both directions; ``interop`` carries a ring across.

The reference's windows call ``jax.core.trace_state_clean``, which jax
0.9.0 moved to ``jax._src.core``; each test here that runs them aliases it
back first (ROADMAP §C).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.sketch import ExecutionPlan as RefPlan
from repro.sketch import HybridWindowedBank as RefHybridRing
from repro.sketch import MultiResWindowedBank as RefMultiRes
from repro.sketch import WindowedBank as RefRing
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch import interop
from repro_torch.kernels.window_fold import window_fold_max_plain
from repro_torch.sketch import plan as plan_registry
from repro_torch.sketch import (
    ExecutionPlan,
    HLLConfig,
    HybridWindowedBank,
    MultiResWindowedBank,
    WindowedBank,
    available_window_backends,
    available_window_merge_backends,
    get_window_merge_backend,
    register_window_backend,
)

DEVICE_RTOL = 1e-6  # the estimator bound (tests/test_torch_estimators.py)
PORT_PLANS = ("torch", "cuda", "cuda_pipelined")


@pytest.fixture(autouse=True)
def _trace_state_alias(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)


def _tick(rows, n, seed):
    """One epoch of Zipf(1.2) tenant keys with foreign keys mixed in."""
    rng = np.random.default_rng(seed)
    keys = ((rng.zipf(1.2, n) - 1) % (rows + 2) - 1).astype(np.int32)
    return keys, rng.integers(0, 2**31, n, dtype=np.int32)


# (op, argument) walk: "o" observe a tick, "a" advance by k, "t" advance_to
# the current epoch + k (a jump of W or more expires the whole ring)
WALK = [("o", 0), ("a", 1), ("o", 1), ("o", 2), ("a", 2), ("o", 3), ("t", 1), ("o", 4), ("a", 1),
        ("o", 5), ("t", 7), ("o", 6), ("a", 3), ("o", 7), ("t", 0), ("o", 8), ("a", 1), ("o", 9)]


def _step(ring, op, arg, rows, plan):
    if op == "o":
        keys, items = _tick(rows, 700, arg)
        if isinstance(ring, (RefRing, RefHybridRing, RefMultiRes)):
            return ring.observe(jnp.asarray(keys), jnp.asarray(items), plan)
        return ring.observe(keys, items, plan)
    if op == "a":
        return ring.advance(arg)
    return ring.advance_to(ring.epoch + arg)


@pytest.mark.parametrize("backend", PORT_PLANS)
def test_windowed_bank_walk_matches_reference(backend):
    window, rows, p = 5, 6, 8
    ring = WindowedBank.empty(window, rows, HLLConfig(p=p, hash_bits=64), device="cpu")
    ref = RefRing.empty(window, rows, RefConfig(p=p, hash_bits=64))
    plan, ref_plan = ExecutionPlan(backend=backend), RefPlan(backend="jnp")
    for op, arg in WALK:
        ring, ref = _step(ring, op, arg, rows, plan), _step(ref, op, arg, rows, ref_plan)
        np.testing.assert_array_equal(ring.registers.numpy(), np.asarray(ref.registers))
        np.testing.assert_array_equal(ring.counts, ref.counts)
        np.testing.assert_array_equal(ring.epochs, np.asarray(ref.epochs))
        assert ring.cursor == int(ref.cursor) and ring.epoch == ref.epoch
        for last_k in (1, 3, window):
            got, want = ring.fold_window(last_k, plan), ref.fold_window(last_k, ref_plan)
            assert got.to_bytes() == want.to_bytes()
            np.testing.assert_allclose(ring.estimate_window(last_k, plan).numpy(),
                                       np.asarray(ref.estimate_window(last_k, ref_plan)), rtol=DEVICE_RTOL)
            np.testing.assert_array_equal(ring.window_counts(last_k), ref.window_counts(last_k))
        assert got.estimate(2) == want.estimate(2)
    assert ring.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("backend", PORT_PLANS)
@pytest.mark.parametrize("stride", [1, 2])
def test_incremental_full_read_equals_cold_fold(backend, stride, monkeypatch):
    window, rows = 4, 5
    rebuilds = []
    rebuild = WindowedBank._rebuild_suffix
    monkeypatch.setattr(WindowedBank, "_rebuild_suffix", lambda self: rebuilds.append(1) or rebuild(self))
    ring = WindowedBank.empty(window, rows, HLLConfig(p=6, hash_bits=32), device="cpu")
    plan = ExecutionPlan(backend=backend)
    for epoch in range(3 * window):
        keys, items = _tick(rows, 300, epoch)
        ring = ring.observe(keys, items, plan)
        cold = window_fold_max_plain(ring.registers, torch.ones(window, dtype=torch.bool))
        torch.testing.assert_close(ring.fold_window(plan=plan).registers, cold, rtol=0, atol=0)
        # a second read on the same instance is the cached fold
        assert ring._fold_registers(window, plan) is ring._fold_registers(window, plan)
        ring = ring.advance(stride)
    # the prefix stack rebuilds once per W rotations (DESIGN.md §14)
    assert len(rebuilds) == 3 * stride


def test_window_axes_register_every_backend_and_merge_falls_back(monkeypatch):
    for name in PORT_PLANS:
        assert name in available_window_backends() and name in available_window_merge_backends()
    # a plugin backend with an ingest entry but no window entries (registered
    # through monkeypatch so the registries are restored afterwards)
    name = "spy_plugin"
    monkeypatch.setitem(plan_registry._BACKENDS, name, plan_registry.get_backend("torch"))
    assert get_window_merge_backend(name) is get_window_merge_backend("torch")
    ring = WindowedBank.empty(2, 2, HLLConfig(p=4), device="cpu")
    with pytest.raises(ValueError, match="no window fold path"):
        ring.estimate_window(plan=ExecutionPlan(backend=name))
    monkeypatch.setitem(plan_registry._WINDOW_BACKENDS, name, plan_registry.get_window_backend("torch"))
    torch.testing.assert_close(ring.estimate_window(plan=ExecutionPlan(backend=name)), ring.estimate_window(),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="already registered"):
        register_window_backend("torch")(lambda ring, mask, cfg, plan: None)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_hybrid_ring_walk_matches_reference(backend):
    window, rows, p = 4, 8, 6
    ring = HybridWindowedBank.empty(window, rows, HLLConfig(p=p, hash_bits=64), device="cpu")
    ref = RefHybridRing.empty(window, rows, RefConfig(p=p, hash_bits=64))
    plan, ref_plan = ExecutionPlan(backend=backend), RefPlan(backend="jnp")
    for op, arg in WALK[:12]:
        ring, ref = _step(ring, op, arg, rows, plan), _step(ref, op, arg, rows, ref_plan)
        np.testing.assert_array_equal(ring.counts, ref.counts)
        assert ring.cursor == ref.cursor and ring.epoch == ref.epoch
        for last_k in (1, window):
            got, want = ring.fold_window(last_k, plan), ref.fold_window(last_k)
            assert got.to_bytes() == want.to_bytes()
            np.testing.assert_allclose(ring.estimate_window(last_k, plan).numpy(),
                                       np.asarray(ref.estimate_window(last_k)), rtol=DEVICE_RTOL)
    assert ring.density() == ref.density()
    blob = ring.to_bytes()
    assert blob == ref.to_bytes() and RefHybridRing.from_bytes(blob).to_bytes() == blob
    assert HybridWindowedBank.from_bytes(ref.to_bytes(), device="cpu").to_bytes() == blob


def test_multires_ring_walk_matches_reference():
    base, levels, rows = 2, 3, 5
    ring = MultiResWindowedBank.empty(base, rows, HLLConfig(p=6, hash_bits=64), levels, device="cpu")
    ref = RefMultiRes.empty(base, rows, RefConfig(p=6, hash_bits=64), levels)
    plan, ref_plan = ExecutionPlan(backend="cuda"), RefPlan(backend="jnp")
    for epoch in range(16):
        keys, items = _tick(rows, 300, epoch)
        if epoch % 5 != 4:  # empty epochs leave gaps in the labels
            ring = ring.observe(keys, items, plan)
            ref = ref.observe(jnp.asarray(keys), jnp.asarray(items), ref_plan)
        for last_k in (1, 4, ring.horizon):
            assert ring.fold_window(last_k, plan).to_bytes() == ref.fold_window(last_k, ref_plan).to_bytes()
            np.testing.assert_allclose(ring.estimate_window(last_k, plan).numpy(),
                                       np.asarray(ref.estimate_window(last_k, ref_plan)), rtol=DEVICE_RTOL)
        assert ring.to_bytes() == ref.to_bytes() and ring.density() == ref.density()
        ring, ref = ring.advance(1 + epoch % 3 // 2), ref.advance(1 + epoch % 3 // 2)
    # a jump past the horizon expires every closed bucket
    ring, ref = ring.advance_to(ring.epoch + ring.horizon), ref.advance_to(ref.epoch + ref.horizon)
    keys, items = _tick(rows, 300, 99)
    ring, ref = ring.observe(keys, items, plan), ref.observe(jnp.asarray(keys), jnp.asarray(items), ref_plan)
    assert ring.slots == ref.slots == 1
    blob = ring.to_bytes()
    assert RefMultiRes.from_bytes(blob).to_bytes() == blob
    assert MultiResWindowedBank.from_bytes(ref.to_bytes(), device="cpu").to_bytes() == blob


def test_rhlw_bytes_cross_in_both_directions_and_interop():
    window, rows = 3, 4
    ring = WindowedBank.empty(window, rows, HLLConfig(p=5, hash_bits=32, seed=9), device="cpu")
    for epoch in range(5):
        ring = ring.observe(*_tick(rows, 200, epoch)).advance()
    blob = ring.to_bytes()
    ref = RefRing.from_bytes(blob)
    assert ref.to_bytes() == blob
    assert WindowedBank.from_bytes(ref.to_bytes(), device="cpu").to_bytes() == blob
    # a dense ring parses as an all-dense hybrid ring, in both packages alike
    assert HybridWindowedBank.from_bytes(blob, device="cpu").to_bytes() == RefHybridRing.from_bytes(blob).to_bytes()
    state = interop.window_to_reference_state(ring)
    rebuilt = RefRing(jnp.asarray(state["registers"]), jnp.asarray(state["n_items"]),
                      jnp.asarray(state["cursor"], jnp.int32), jnp.asarray(state["epochs"]), ref.cfg)
    assert rebuilt.to_bytes() == blob
    back = interop.window_from_reference_state(
        {"registers": ref.registers, "n_items": ref.n_items, "cursor": ref.cursor, "epochs": ref.epochs},
        5, 32, 9, device="cpu")
    assert back.to_bytes() == blob
    for version, hint in ((2, "HybridWindowedBank"), (3, "MultiResWindowedBank")):
        with pytest.raises(ValueError, match=hint):
            WindowedBank.from_bytes(blob[:4] + bytes([version]) + blob[5:], device="cpu")
    for cut in (10, 40, len(blob) - 1):
        with pytest.raises(ValueError):
            WindowedBank.from_bytes(blob[:cut], device="cpu")


def test_validation_matches_reference_messages():
    ring = WindowedBank.empty(4, 2, HLLConfig(p=4), device="cpu")
    ref = RefRing.empty(4, 2, RefConfig(p=4))
    for bad in (0, 5):
        with pytest.raises(ValueError) as got:
            ring.estimate_window(bad)
        with pytest.raises(ValueError) as want:
            ref.estimate_window(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="steps >= 1"):
        ring.advance(0)
    assert ring.advance_to(-3).epoch == 0  # the past never returns
    grown = ring.observe(np.array([1], np.int32), np.array([7], np.int32)).with_rows(5)
    assert grown.rows == 5 and grown.counts[0].tolist() == [0, 1, 0, 0, 0]
