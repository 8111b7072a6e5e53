"""Port vs reference: the count-min family (CountMinBank, WindowedCountMinBank).

* ``update_many`` under the port's ``torch``, ``cuda`` and
  ``cuda_pipelined`` plans (plain versions on the CPU) against the
  reference's ``jnp`` plan and its ``pallas`` plan in interpret mode
  (d*w <= 4096, its VMEM cap): counters, Topkapi labels, votes and exact
  counts bit-identical, at n in {1, 1000, 4099} with keys -1 and B mixed in;
  then ``merge``, ``query``, ``topk`` and RCMB bytes in both directions.
* A seeded ``WindowedCountMinBank`` walk (observe, advance, advance_to
  jumps of W and more): ``fold_window``, ``query_window``, ``topk_window``
  and RCMW bytes after every step.
* Counters seeded near 2^32 through ``interop``, so that ingest, merge and
  the window fold wrap; the query and ``topk`` rank them as unsigned.
* The short circuits (empty stream, zero-row bank dispatch nothing), the
  cell-space guard, the mesh placement, config and wire validation.

The reference's windowed carriers call ``jax.core.trace_state_clean``,
which jax 0.9.0 moved to ``jax._src.core``; an autouse fixture aliases it
back (ROADMAP §C).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.sketch import CMConfig as RefCMConfig
from repro.sketch import CountMinBank as RefCMB
from repro.sketch import ExecutionPlan as RefPlan
from repro.sketch import WindowedCountMinBank as RefCMW
from repro_torch import interop
from repro_torch.sketch import plan as plan_registry
from repro_torch.sketch import (
    CMConfig,
    CountMinBank,
    ExecutionPlan,
    WindowedCountMinBank,
    available_cm_backends,
    available_cm_window_backends,
    cm_update_many,
    query_cm_counters,
    register_cm_backend,
    update_cm_counters,
)
from repro_torch.sketch.countmin import cm_hash_index
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.sketch.backends import cm_update_torch
from repro_torch.sketch.dispatch import cm_mesh_sum

PORT_PLANS = ("torch", "cuda", "cuda_pipelined")
REF_PLANS = ("jnp", "pallas")
CFG = CMConfig(depth=4, width=64, seed=5)
RCFG = RefCMConfig(depth=4, width=64, seed=5)
ROWS = 6
EDGE_ITEMS = np.array([0, -1, -(2**31), 2**31 - 1, 1], dtype=np.int32)


@pytest.fixture(autouse=True)
def _trace_state_alias(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)


def _stream(n, rows, seed):
    """Zipf-heavy int32 items with Zipf tenant keys; keys -1 and B mixed in."""
    rng = np.random.default_rng(seed)
    keys = ((rng.zipf(1.3, n) - 1) % (rows + 2) - 1).astype(np.int32)
    keys[: min(n, 2)] = [-1, rows][: min(n, 2)]
    items = (rng.zipf(1.2, n) % 97).astype(np.int32)
    items[: min(n, EDGE_ITEMS.size)] = EDGE_ITEMS[: min(n, EDGE_ITEMS.size)]
    return keys, items


def _same_bank(port: CountMinBank, ref: RefCMB) -> None:
    np.testing.assert_array_equal(port.counters.numpy().view(np.uint32), np.asarray(ref.counters))
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(port.label_counts.numpy(), np.asarray(ref.label_counts))
    np.testing.assert_array_equal(port.counts, ref.counts)


@functools.lru_cache(maxsize=None)
def _ref_ingest(ref_backend: str, n: int) -> RefCMB:
    keys, items = _stream(n, ROWS, n)
    half = n // 2
    bank = RefCMB.empty(ROWS, RCFG)
    for k, x in ((keys[:half], items[:half]), (keys[half:], items[half:])):
        bank = bank.update_many(jnp.asarray(k), jnp.asarray(x), RefPlan(backend=ref_backend, interpret=True))
    return bank


def _port_ingest(backend: str, n: int) -> CountMinBank:
    keys, items = _stream(n, ROWS, n)
    half = n // 2
    bank = CountMinBank.empty(ROWS, CFG, device="cpu")
    for k, x in ((keys[:half], items[:half]), (keys[half:], items[half:])):
        bank = bank.update_many(k, x, ExecutionPlan(backend=backend))
    return bank


def test_cm_axes_register_every_backend():
    assert available_cm_backends() == ("cuda", "cuda_pipelined", "torch")
    assert available_cm_window_backends() == ("cuda", "cuda_pipelined", "torch")
    with pytest.raises(ValueError, match="already registered"):
        register_cm_backend("torch", None, None)


def test_cm_hash_index_matches_reference():
    items = np.concatenate([EDGE_ITEMS, np.random.default_rng(1).integers(-(2**31), 2**31, 3000).astype(np.int32)])
    for cfg in (CFG, CMConfig(16, 1000, 2**64 - 1), CMConfig(1, 1, 0), CMConfig(3, 1 << 24, 7)):
        rcfg = RefCMConfig(cfg.depth, cfg.width, cfg.seed)
        got = cm_hash_index(torch.from_numpy(items), cfg)
        assert got.dtype == torch.int32 and tuple(got.shape) == (cfg.depth, items.size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(_ref_cm_hash_index(items, rcfg)))


def _ref_cm_hash_index(items, rcfg):
    from repro.sketch import cm_hash_index as ref_cm_hash_index

    return ref_cm_hash_index(jnp.asarray(items), rcfg)


@pytest.mark.parametrize("n", [1, 1000, 4099])
@pytest.mark.parametrize("ref_backend", REF_PLANS)
@pytest.mark.parametrize("backend", PORT_PLANS)
def test_update_many_matches_reference(backend, ref_backend, n):
    _same_bank(_port_ingest(backend, n), _ref_ingest(ref_backend, n))


@pytest.mark.parametrize("backend", PORT_PLANS)
def test_merge_query_topk_and_bytes_match_reference(backend):
    plan = ExecutionPlan(backend=backend)
    a, b = _port_ingest(backend, 1000), _port_ingest(backend, 4099)
    ra, rb = _ref_ingest("jnp", 1000), _ref_ingest("jnp", 4099)
    merged, ref_merged = a.merge(b), ra.merge(rb)
    _same_bank(merged, ref_merged)
    _same_bank(b | a, rb | ra)
    probes = np.concatenate([EDGE_ITEMS, np.arange(-3, 120, dtype=np.int32)])
    got = merged.query(probes, plan)
    assert got.dtype == torch.int64 and tuple(got.shape) == (ROWS, probes.size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_merged.query(jnp.asarray(probes))))
    for k in (1, 5, 300):  # 300 > the distinct labels of a row: padded with -1 / 0
        for port_top, ref_top in zip(merged.topk(k), ref_merged.topk(k)):
            np.testing.assert_array_equal(port_top, ref_top)
            assert port_top.dtype == ref_top.dtype
    blob = merged.to_bytes()
    assert blob == ref_merged.to_bytes()
    _same_bank(CountMinBank.from_bytes(ref_merged.to_bytes(), device="cpu"), ref_merged)
    _same_bank(merged, RefCMB.from_bytes(blob))
    assert merged.nbytes == ref_merged.nbytes


def test_merge_of_halves_equals_one_ingest_and_functional_entries():
    keys, items = _stream(3001, ROWS, 9)
    whole = cm_update_many(CountMinBank.empty(ROWS, CFG, device="cpu"), keys, items)
    first = CountMinBank.empty(ROWS, CFG, device="cpu").update_many(keys[:1500], items[:1500])
    second = CountMinBank.empty(ROWS, CFG, device="cpu").update_many(keys[1500:], items[1500:])
    merged = first.merge(second)
    torch.testing.assert_close(merged.counters, whole.counters, rtol=0, atol=0)
    np.testing.assert_array_equal(merged.counts, whole.counts)
    raw = update_cm_counters(torch.zeros((ROWS, CFG.depth, CFG.width), dtype=torch.int32), keys, items, CFG)
    torch.testing.assert_close(raw, whole.counters, rtol=0, atol=0)
    torch.testing.assert_close(query_cm_counters(raw, items[:50], CFG), whole.query(items[:50]), rtol=0, atol=0)
    with pytest.raises(ValueError, match="different configs"):
        whole.merge(CountMinBank.empty(ROWS, CMConfig(4, 32, 5), device="cpu"))
    with pytest.raises(ValueError, match="different sizes"):
        whole.merge(CountMinBank.empty(ROWS + 1, CFG, device="cpu"))


def test_query_never_undercounts_and_topk_finds_the_heavy_hitter():
    rng = np.random.default_rng(4)
    rows = 3
    keys = rng.integers(0, rows, 6000).astype(np.int32)
    items = rng.integers(0, 5000, 6000).astype(np.int32)
    items[::4] = 4242  # one heavy hitter in every row
    bank = CountMinBank.empty(rows, CMConfig(3, 128, 1), device="cpu").update_many(keys, items)
    probes = np.unique(items)
    est = bank.query(probes).numpy()
    for b in range(rows):
        exact = np.array([np.sum((keys == b) & (items == x)) for x in probes])
        assert (est[b] >= exact).all()
    values, counts = bank.topk(3)
    heavy = np.array([np.sum((keys == b) & (items == 4242)) for b in range(rows)])
    assert (values[:, 0] == 4242).all() and (counts[:, 0] >= heavy).all()
    with pytest.raises(ValueError, match="k >= 1"):
        bank.topk(0)


# (op, argument) walk: "o" observe a tick, "a" advance by k, "t" advance_to
# the current epoch + k (a jump of W or more expires the whole ring)
WALK = [("o", 0), ("a", 1), ("o", 1), ("o", 2), ("a", 2), ("o", 3), ("t", 1), ("o", 4), ("a", 1),
        ("o", 5), ("t", 4), ("o", 6), ("a", 3), ("o", 7), ("t", 0), ("o", 8), ("t", 9), ("o", 9)]


def _step(ring, op, arg, plan):
    if op == "o":
        keys, items = _stream(500, ROWS, 100 + arg)
        if isinstance(ring, RefCMW):
            return ring.observe(jnp.asarray(keys), jnp.asarray(items), plan)
        return ring.observe(keys, items, plan)
    if op == "a":
        return ring.advance(arg)
    return ring.advance_to(ring.epoch + arg)


@pytest.mark.parametrize("backend", PORT_PLANS)
def test_windowed_walk_matches_reference(backend):
    window = 4
    ring = WindowedCountMinBank.empty(window, ROWS, CFG, device="cpu")
    ref = RefCMW.empty(window, ROWS, RCFG)
    plan, ref_plan = ExecutionPlan(backend=backend), RefPlan(backend="jnp")
    probes = np.arange(-2, 60, dtype=np.int32)
    for op, arg in WALK:
        ring, ref = _step(ring, op, arg, plan), _step(ref, op, arg, ref_plan)
        np.testing.assert_array_equal(ring.epochs, np.asarray(ref.epochs))
        assert ring.cursor == int(ref.cursor) and ring.epoch == ref.epoch
        np.testing.assert_array_equal(ring.counts, ref.counts)
        for last_k in (1, 2, window):
            _same_bank(ring.fold_window(last_k, plan), ref.fold_window(last_k, ref_plan))
            np.testing.assert_array_equal(ring.query_window(probes, last_k, plan).numpy(),
                                          np.asarray(ref.query_window(jnp.asarray(probes), last_k, ref_plan)))
            for port_top, ref_top in zip(ring.topk_window(4, last_k, plan), ref.topk_window(4, last_k, ref_plan)):
                np.testing.assert_array_equal(port_top, ref_top)
            np.testing.assert_array_equal(ring.window_counts(last_k), ref.window_counts(last_k))
        blob = ring.to_bytes()
        assert blob == ref.to_bytes()
    back = WindowedCountMinBank.from_bytes(blob, device="cpu")
    assert back.to_bytes() == blob and back.cursor == ring.cursor
    assert RefCMW.from_bytes(blob).to_bytes() == blob


def _near_wrap_state(rows, cfg, seed, window=None):
    """Reference-layout state whose counters sit within 40 of 2^32."""
    rng = np.random.default_rng(seed)
    shape = (rows, cfg.depth, cfg.width) if window is None else (window, rows, cfg.depth, cfg.width)
    state = {
        "counters": (2**32 - rng.integers(1, 40, shape)).astype(np.uint32),
        "labels": rng.integers(0, 50, shape).astype(np.int32),
        "label_counts": rng.integers(0, 5, shape).astype(np.int32),
        "n_items": np.stack([np.zeros(shape[:-2], np.uint32), np.full(shape[:-2], 2**32 - 7, np.uint32)], -1),
    }
    if window is not None:
        state.update(cursor=window - 1, epochs=np.arange(window, dtype=np.int32))
    return state


@pytest.mark.parametrize("backend", PORT_PLANS)
def test_counters_near_2_32_wrap_and_rank_unsigned(backend):
    plan = ExecutionPlan(backend=backend)
    state = _near_wrap_state(ROWS, CFG, 2)
    bank = interop.countmin_from_reference_state(state, CFG.depth, CFG.width, CFG.seed, device="cpu")
    ref = RefCMB(*(jnp.asarray(state[f]) for f in ("counters", "labels", "label_counts", "n_items")), RCFG)
    _same_bank(bank, ref)
    keys, items = _stream(4099, ROWS, 3)
    bank = bank.update_many(keys, items, plan)
    ref = ref.update_many(jnp.asarray(keys), jnp.asarray(items))
    _same_bank(bank, ref)
    assert (bank.counters.numpy() >= 0).any() and (bank.counters.numpy() < 0).any()  # some wrapped
    _same_bank(bank.merge(bank), ref.merge(ref))
    probes = np.arange(0, 97, dtype=np.int32)
    got = bank.query(probes, plan).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.query(jnp.asarray(probes))))
    # the min over d is unsigned: nothing near 2^32 loses to a wrapped counter's sign
    assert got.min() >= 0 and got.max() < 2**32
    for port_top, ref_top in zip(bank.topk(6), ref.topk(6)):
        np.testing.assert_array_equal(port_top, ref_top)
    assert bank.to_bytes() == ref.to_bytes()
    np.testing.assert_array_equal(interop.countmin_to_reference_state(bank)["counters"], np.asarray(ref.counters))


@pytest.mark.parametrize("backend", PORT_PLANS)
def test_window_fold_wraps_like_reference(backend):
    window = 3
    state = _near_wrap_state(ROWS, CFG, 5, window)
    ring = interop.cm_window_from_reference_state(state, CFG.depth, CFG.width, CFG.seed, device="cpu")
    ref = RefCMW(
        *(jnp.asarray(state[f]) for f in ("counters", "labels", "label_counts", "n_items")),
        jnp.asarray(state["cursor"], jnp.int32), jnp.asarray(state["epochs"]), RCFG,
    )
    keys, items = _stream(1000, ROWS, 6)
    ring = ring.observe(keys, items, ExecutionPlan(backend=backend))
    ref = ref.observe(jnp.asarray(keys), jnp.asarray(items))
    for last_k in (1, 2, 3):
        _same_bank(ring.fold_window(last_k, ExecutionPlan(backend=backend)), ref.fold_window(last_k))
    assert ring.to_bytes() == ref.to_bytes()
    back = interop.cm_window_to_reference_state(ring)
    for field in ("counters", "labels", "label_counts", "n_items", "epochs"):
        np.testing.assert_array_equal(back[field], np.asarray(getattr(ref, field)))
    assert back["cursor"] == int(ref.cursor)


def _spy(monkeypatch):
    """Register a "spy" backend on every axis (through monkeypatch, so the
    registries are restored afterwards) that counts its dispatches."""
    calls = []
    torch_cm = plan_registry.get_cm_backend("torch")
    monkeypatch.setitem(plan_registry._BACKENDS, "spy", plan_registry.get_backend("torch"))
    monkeypatch.setitem(plan_registry._CM_BACKENDS, "spy", plan_registry.CMBackend(
        lambda *a: calls.append("ingest") or torch_cm.ingest(*a),
        lambda *a: calls.append("query") or torch_cm.query(*a),
    ))
    fold = plan_registry.get_cm_window_backend("torch")
    monkeypatch.setitem(plan_registry._CM_WINDOW_BACKENDS, "spy",
                        lambda *a: calls.append("fold") or fold(*a))
    return calls, ExecutionPlan(backend="spy")


def test_short_circuits_dispatch_nothing(monkeypatch):
    calls, plan = _spy(monkeypatch)
    bank = CountMinBank.empty(3, CFG, device="cpu")
    empty = np.zeros(0, np.int32)
    assert bank.update_many(empty, empty, plan) is bank
    assert tuple(bank.query(empty, plan).shape) == (3, 0)
    zero = CountMinBank(*(t[:0] for t in (bank.counters, bank.labels, bank.label_counts, bank.n_items)), CFG)
    keys, items = _stream(64, 4, 21)
    assert zero.update_many(keys, items, plan) is zero
    assert tuple(zero.query(items, plan).shape) == (0, 64)
    values, counts = zero.topk(4)
    assert values.shape == (0, 4) and counts.shape == (0, 4)
    with pytest.raises(ValueError, match="same length"):
        bank.update_many(np.zeros(2, np.int32), np.zeros(3, np.int32))
    win = WindowedCountMinBank.empty(3, 2, CFG, device="cpu")
    assert win.observe(empty, empty, plan) is win
    zr = WindowedCountMinBank(*(t[:, :0] for t in (win.counters, win.labels, win.label_counts, win.n_items)),
                              win.cursor, win.epochs, CFG)
    assert len(zr.fold_window(plan=plan)) == 0
    assert calls == []
    # a live bank and ring DO dispatch: one ingest, one query, one fold
    win = win.observe(*_stream(128, 2, 5), plan)
    bank.update_many(*_stream(16, 3, 5), plan).query(items[:3], plan)
    win.fold_window(plan=plan)
    assert sorted(calls) == ["fold", "ingest", "ingest", "query"]


def test_cell_space_guard_mesh_placement_and_validation():
    wide = CMConfig(depth=16, width=1 << 24)
    with pytest.raises(ValueError, match="overflows int32"):
        update_cm_counters(torch.zeros((8, 1, 1), dtype=torch.int32).expand(8, 16, 1 << 24), [0], [1], wide,
                           ExecutionPlan(backend="torch"))
    with pytest.raises(ValueError, match="requires a mesh"):
        ExecutionPlan(placement="mesh")
    # the mesh rule: keys padded with -1, per-shard zero deltas, one sum
    mesh_plan = ExecutionPlan(backend="torch").with_mesh(make_test_mesh((4,), ("data",), device="cpu"))
    keys, items = _stream(1001, ROWS, 9)
    zero = torch.zeros((ROWS, CFG.depth, CFG.width), dtype=torch.int32)
    want = update_cm_counters(zero, keys, items, CFG, ExecutionPlan(backend="torch"))
    got = cm_mesh_sum(mesh_plan, zero, tuple(torch.from_numpy(a) for a in (keys, items)),
                      lambda cnt, ks, xs: cm_update_torch(cnt, ks, xs, CFG))
    assert torch.equal(got, want)
    for bad in (dict(depth=0), dict(depth=17), dict(width=0), dict(width=(1 << 24) + 1), dict(seed=-1)):
        with pytest.raises(ValueError):
            CMConfig(**bad)
    assert CMConfig().memory_footprint_bits == RefCMConfig().memory_footprint_bits
    with pytest.raises(ValueError, match="at least one row"):
        CountMinBank.empty(0, CFG, device="cpu")
    with pytest.raises(ValueError, match="cannot shrink"):
        CountMinBank.empty(3, CFG, device="cpu").with_rows(2)
    grown = _port_ingest("torch", 1000).with_rows(ROWS + 3)
    _same_bank(grown, _ref_ingest("jnp", 1000).with_rows(ROWS + 3))
    ring = WindowedCountMinBank.empty(3, 2, CFG, device="cpu")
    with pytest.raises(ValueError, match="last_k"):
        ring.fold_window(4)
    with pytest.raises(ValueError, match="steps >= 1"):
        ring.advance(0)
    assert ring.with_rows(5).rows == 5


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.5, 0.99])
def test_wire_formats_reject_truncation_and_garbage(frac):
    bank = _port_ingest("torch", 1000)
    blob = bank.to_bytes()
    cut = blob[: int(len(blob) * frac)]
    with pytest.raises(ValueError):
        CountMinBank.from_bytes(cut, device="cpu")
    with pytest.raises(ValueError):
        RefCMB.from_bytes(cut)
    ring = WindowedCountMinBank.empty(2, 3, CFG, device="cpu").observe(*_stream(100, 3, 1))
    wblob = ring.to_bytes()
    with pytest.raises(ValueError):
        WindowedCountMinBank.from_bytes(wblob[: int(len(wblob) * frac)], device="cpu")
    with pytest.raises(ValueError, match="bad magic"):
        CountMinBank.from_bytes(b"XXXX" + blob[4:], device="cpu")
    with pytest.raises(ValueError, match="bad magic"):
        WindowedCountMinBank.from_bytes(b"XXXX" + wblob[4:], device="cpu")
