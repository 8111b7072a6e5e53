"""Port vs reference: the mesh and row-sharded placements (DESIGN.md §16).

* ``Mesh``, ``make_test_mesh`` and the plan's mesh checks: a device list
  may repeat a device, so four shards run on the one CPU here (the
  reference's tests force four host devices instead).
* Every carrier -- ``SketchBank``, ``HybridBank``, ``WindowedBank``,
  ``CountMinBank`` and a single ``HyperLogLog`` -- under ``mesh`` and
  ``sharded`` plans over a 4-shard mesh, with B = 37 rows (phantom rows in
  the last block) and a stream length that does not divide 4 (edge padding
  for the max lattices, key -1 padding for count-min): registers, counts,
  pairs, rings, counters, estimates and the RHLL/RHLB/RHLW/RCMB bytes are
  bit-identical to the port's ``local`` plan, and the state and bytes to
  the reference's ``jnp`` plan on the same numpy inputs.  Estimates against
  the reference: the exact host path equal, the device path within rtol
  1e-6 (the bound of tests/test_torch_estimators.py).
* The reference's own sharded ``SketchBank`` on four forced host devices
  (a subprocess) gives the port's sharded registers and estimates.
* The serve launcher with ``--placement sharded`` prints what it prints
  with ``local``, over the real one-CPU mesh and over a 4-shard mesh.

The reference's windows call ``jax.core.trace_state_clean``, which jax
0.9.0 moved to ``jax._src.core``; the window test aliases it back first
(ROADMAP C).
"""

import contextlib
import io
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sketch import CMConfig as RefCMConfig
from repro.sketch import CountMinBank as RefCMB
from repro.sketch import ExecutionPlan as RefPlan
from repro.sketch import HybridBank as RefHybrid
from repro.sketch import HyperLogLog as RefHLL
from repro.sketch import SketchBank as RefBank
from repro.sketch import WindowedBank as RefRing
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch import interop
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve
from repro_torch.sketch import (
    CMConfig,
    CountMinBank,
    ExecutionPlan,
    HLLConfig,
    HybridBank,
    HyperLogLog,
    SketchBank,
    WindowedBank,
    example_plans,
    update_cm_counters,
)
from repro_torch.sketch.dispatch import row_shard_apply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 37  # divides no shard count > 1: the last block holds phantom rows
N = 1001  # divides no shard count > 1: the streams are padded
CFG, RCFG = HLLConfig(p=8, hash_bits=64), RefConfig(p=8, hash_bits=64)
CM, RCM = CMConfig(depth=3, width=64, seed=5), RefCMConfig(depth=3, width=64, seed=5)
BACKENDS = ("torch", "cuda", "cuda_pipelined")
DEVICE_RTOL = 1e-6  # the estimator bound (tests/test_torch_estimators.py)
MESH = meshlib.make_test_mesh((4,), ("data",), device="cpu")


def _plans(backend):
    local = ExecutionPlan(backend=backend)
    return local, {"mesh": local.with_mesh(MESH), "sharded": local.with_sharding(MESH)}


def _stream(seed, n=N, rows=ROWS, zipf=False):
    """Keys with foreign values mixed in (-1, B, beyond), int32 items."""
    rng = np.random.default_rng(seed)
    if zipf:  # a few hot rows, so that a hybrid bank promotes some
        keys = ((rng.zipf(1.3, n) - 1) % (rows + 2) - 1).astype(np.int32)
    else:
        keys = rng.integers(-2, rows + 2, n).astype(np.int32)
    keys[:3] = [-1, rows, 2**31 - 1]
    items = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    return keys, items


def _equal(a: torch.Tensor, b: torch.Tensor, what: str):
    assert a.dtype == b.dtype and torch.equal(a, b), what


# ----------------------------------------------------------------------------
# the mesh and the plan
# ----------------------------------------------------------------------------


def test_mesh_devices_shards_and_plan_checks():
    cpu = torch.device("cpu")
    grid = meshlib.make_test_mesh((2, 3), ("data", "model"), device="cpu")
    assert grid.shape == {"data": 2, "model": 3} and meshlib.n_chips(grid) == 6
    assert grid.shard_devices(("data",)) == (cpu, cpu)
    assert len(grid.shard_devices(("data", "model"))) == 6
    # a distinct device per position shows the row-major order of the shards
    devs = [torch.device("cpu", i) for i in range(6)]
    named = meshlib.make_auto_mesh((2, 3), ("data", "model"), devs)
    assert [d.index for d in named.shard_devices(("data",))] == [0, 3]
    assert [d.index for d in named.shard_devices(("model",))] == [0, 1, 2]
    assert [d.index for d in named.shard_devices(("model", "data"))] == [0, 3, 1, 4, 2, 5]
    with pytest.raises(ValueError, match="needs 4 devices"):
        meshlib.make_auto_mesh((4,), ("data",), [cpu])
    with pytest.raises(ValueError, match="repeat"):
        meshlib.Mesh((1, 1), ("data", "data"), (cpu,))
    # plans with a mesh stay hashable (folds are cached on them)
    plan = ExecutionPlan().with_sharding(MESH)
    assert hash(plan) == hash(ExecutionPlan().with_sharding(meshlib.make_test_mesh((4,), ("data",), "cpu")))
    assert plan.validate().placement == "sharded" and ExecutionPlan().with_mesh(MESH).placement == "mesh"
    with pytest.raises(ValueError, match="requires a mesh"):
        ExecutionPlan(placement="sharded")
    with pytest.raises(ValueError, match="not in mesh axes"):
        ExecutionPlan().with_mesh(MESH, data_axes=("model",)).validate()
    plans = example_plans(MESH)
    assert {p.placement for p in plans} == {"local", "mesh"}
    assert len(plans) == len(example_plans()) + 3


def test_row_shard_apply_pads_with_phantom_rows_and_keeps_replicated_inputs():
    x = torch.arange(ROWS * 3, dtype=torch.int32).reshape(ROWS, 3)
    bias = torch.tensor([10, 20, 30], dtype=torch.int32)
    seen = []

    def fn(block, b):
        seen.append(block.shape[0])
        return (block + b).T  # out_dim 1

    out = row_shard_apply(ExecutionPlan().with_sharding(MESH), fn, (x, bias), (0, None), out_dim=1)
    assert seen == [10, 10, 10, 10]
    _equal(out, (x + bias).T, "row_shard_apply")


# ----------------------------------------------------------------------------
# the carriers, bit-identical to local and to the reference
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_bank_placements_match_local_and_reference(backend):
    local, plans = _plans(backend)
    chunks = [_stream(s) for s in range(3)]

    def run(plan):
        bank = SketchBank.empty(ROWS, CFG, "cpu")
        for keys, items in chunks:
            bank = bank.update_many(keys, items, plan)
        return bank

    want = run(local)
    ref = RefBank.empty(ROWS, RCFG)
    for keys, items in chunks:
        ref = ref.update_many(jnp.asarray(keys), jnp.asarray(items), RefPlan(backend="jnp"))
    regs, limbs = interop.to_reference_state(want)
    np.testing.assert_array_equal(regs, np.asarray(ref.registers))
    np.testing.assert_array_equal(limbs, np.asarray(ref.n_items))
    ref_est = np.asarray(ref.estimate_many())
    for name, plan in plans.items():
        got = run(plan)
        _equal(got.registers, want.registers, name)
        _equal(got.n_items, want.n_items, name)
        assert got.to_bytes() == want.to_bytes() == ref.to_bytes(), name
        est = got.estimate_many(plan=plan)
        _equal(est, want.estimate_many(plan=local), name)
        np.testing.assert_allclose(est.numpy(), ref_est, rtol=DEVICE_RTOL, err_msg=name)
        assert [got.estimate(i) for i in (0, 17, 36)] == [ref.estimate(i) for i in (0, 17, 36)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_sketch_placements_match_local_and_reference(backend):
    local, plans = _plans(backend)
    _, items = _stream(7, n=4099)
    want = HyperLogLog.empty(CFG, "cpu").update(items, local)
    ref = RefHLL.empty(RCFG).update(jnp.asarray(items), RefPlan(backend="jnp"))
    np.testing.assert_array_equal(want.registers.numpy(), np.asarray(ref.registers))
    for name, plan in plans.items():
        got = HyperLogLog.empty(CFG, "cpu").update(items, plan)
        _equal(got.registers, want.registers, name)
        assert got.to_bytes() == ref.to_bytes() and got.estimate() == ref.estimate(), name
        # a stream shorter than the shard count repeats its one element
        one = HyperLogLog.empty(CFG, "cpu").update(items[:1], plan)
        _equal(one.registers, HyperLogLog.empty(CFG, "cpu").update(items[:1], local).registers, name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hybrid_placements_match_local_and_reference(backend):
    local, plans = _plans(backend)
    chunks = [_stream(10 + s, n=3001, zipf=True) for s in range(3)]

    def run(plan):
        bank = HybridBank.empty(ROWS, CFG, device="cpu")
        for keys, items in chunks:
            bank = bank.update_many(keys, items, plan)
        return bank

    want = run(local)
    ref = RefHybrid.empty(ROWS, RCFG)
    for keys, items in chunks:
        ref = ref.update_many(jnp.asarray(keys), jnp.asarray(items), RefPlan(backend="jnp"))
    assert 0 < int(want.compact().dense_block.shape[0]) < ROWS  # both layouts in play
    assert want.to_bytes() == ref.to_bytes()
    ref_est = np.asarray(ref.estimate_many())
    for name, plan in plans.items():
        got = run(plan)
        assert got.to_bytes() == want.to_bytes(), name
        state, want_state = interop.hybrid_to_reference_state(got), interop.hybrid_to_reference_state(want)
        for field in ("pair_buf", "pair_len", "dense_block", "slot_map", "n_items"):
            np.testing.assert_array_equal(state[field], want_state[field], err_msg=f"{name} {field}")
        for lc_fast in (True, False):
            est = got.estimate_many(plan=plan, lc_fast=lc_fast)
            _equal(est, want.estimate_many(plan=local, lc_fast=lc_fast), f"{name} lc_fast={lc_fast}")
        np.testing.assert_allclose(got.estimate_many(plan=plan).numpy(), ref_est, rtol=DEVICE_RTOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_window_placements_match_local_and_reference(backend, monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    local, plans = _plans(backend)
    window = 4
    rings = {"local": WindowedBank.empty(window, ROWS, CFG, device="cpu")}
    rings.update({name: WindowedBank.empty(window, ROWS, CFG, device="cpu") for name in plans})
    ref = RefRing.empty(window, ROWS, RCFG)
    all_plans = dict(plans, local=local)
    for epoch in range(7):
        keys, items = _stream(20 + epoch, n=N - epoch)
        ref = ref.observe(jnp.asarray(keys), jnp.asarray(items), RefPlan(backend="jnp"))
        rings = {name: ring.observe(keys, items, all_plans[name]) for name, ring in rings.items()}
        want = rings["local"]
        for last_k in (None, 1, 3):
            want_est = want.estimate_window(last_k, local)
            ref_est = np.asarray(ref.estimate_window(last_k))
            np.testing.assert_allclose(want_est.numpy(), ref_est, rtol=DEVICE_RTOL)
            for name, plan in plans.items():
                _equal(rings[name].estimate_window(last_k, plan), want_est, f"{name} epoch {epoch} k={last_k}")
                _equal(rings[name].fold_window(last_k, plan).registers,
                       want.fold_window(last_k, local).registers, f"{name} fold")
        for name in plans:
            _equal(rings[name].registers, want.registers, f"{name} ring")
            assert rings[name].to_bytes() == want.to_bytes() == ref.to_bytes(), name
        ref = ref.advance()
        rings = {name: ring.advance() for name, ring in rings.items()}


@pytest.mark.parametrize("backend", BACKENDS)
def test_countmin_placements_match_local_and_reference(backend):
    local, plans = _plans(backend)
    chunks = [_stream(30 + s, n=N + 2 * s) for s in range(3)]

    def run(plan):
        bank = CountMinBank.empty(ROWS, CM, device="cpu")
        for keys, items in chunks:
            bank = bank.update_many(keys, items, plan)
        return bank

    want = run(local)
    ref = RefCMB.empty(ROWS, RCM)
    for keys, items in chunks:
        ref = ref.update_many(jnp.asarray(keys), jnp.asarray(items), RefPlan(backend="jnp"))
    assert want.to_bytes() == ref.to_bytes()
    probes = chunks[0][1][:50]
    for name, plan in plans.items():
        got = run(plan)
        assert got.to_bytes() == want.to_bytes(), name
        state, want_state = interop.countmin_to_reference_state(got), interop.countmin_to_reference_state(want)
        for field in ("counters", "labels", "label_counts", "n_items"):
            np.testing.assert_array_equal(state[field], want_state[field], err_msg=f"{name} {field}")
        _equal(got.query(probes, plan), want.query(probes, local), name)
    # the sum wraps as uint32 and the -1 padding keys add nothing
    preset = torch.full((ROWS, CM.depth, CM.width), -1, dtype=torch.int32)  # 0xFFFFFFFF
    keys, items = _stream(40)
    want_counters = update_cm_counters(preset, keys, items, CM, local)
    assert bool((want_counters >= 0).any())  # some counters wrapped past 2^32
    for name, plan in plans.items():
        _equal(update_cm_counters(preset, keys, items, CM, plan), want_counters, name)


def test_placement_over_a_two_axis_mesh():
    grid = meshlib.make_test_mesh((2, 2), ("data", "model"), device="cpu")
    local = ExecutionPlan(backend="torch")
    keys, items = _stream(50)
    want = SketchBank.empty(ROWS, CFG, "cpu").update_many(keys, items, local)
    for axes in (("data",), ("data", "model")):
        for plan in (local.with_mesh(grid, axes), local.with_sharding(grid, axes)):
            got = SketchBank.empty(ROWS, CFG, "cpu").update_many(keys, items, plan)
            _equal(got.registers, want.registers, f"{plan.placement} {axes}")


def test_reference_sharded_bank_on_four_forced_devices_matches_port(tmp_path):
    """The reference's own row-sharded SketchBank on four forced host
    devices (pinned before jax starts, hence the subprocess) against the
    port's sharded bank on the 4-shard CPU mesh."""
    out = tmp_path / "ref.npz"
    code = f"""
        import numpy as np
        import jax
        import jax.numpy as jnp
        assert jax.device_count() == 4, jax.device_count()
        from repro.launch.mesh import make_auto_mesh
        from repro.sketch import ExecutionPlan, HLLConfig, SketchBank

        plan = ExecutionPlan(backend="jnp").with_sharding(make_auto_mesh((4,), ("data",)))
        data = np.load({str(tmp_path / "in.npz")!r})
        bank = SketchBank.empty({ROWS}, HLLConfig(p=8, hash_bits=64))
        bank = bank.update_many(jnp.asarray(data["keys"]), jnp.asarray(data["items"]), plan)
        np.savez({str(out)!r}, registers=np.asarray(bank.registers), n_items=np.asarray(bank.n_items),
                 estimates=np.asarray(bank.estimate_many(plan=plan)))
    """
    keys, items = _stream(60)
    np.savez(tmp_path / "in.npz", keys=keys, items=items)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = np.load(out)
    _, plans = _plans("cuda")
    got = SketchBank.empty(ROWS, CFG, "cpu").update_many(keys, items, plans["sharded"])
    regs, limbs = interop.to_reference_state(got)
    np.testing.assert_array_equal(regs, ref["registers"])
    np.testing.assert_array_equal(limbs, ref["n_items"])
    np.testing.assert_allclose(got.estimate_many(plan=plans["sharded"]).numpy(), ref["estimates"],
                               rtol=DEVICE_RTOL)


# ----------------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------------

LAUNCH = ["--device", "cpu", "--arch", "rwkv6-3b", "--requests", "5", "--prompt-len", "12", "--gen-len", "4",
          "--window-epochs", "2"]


def _launch(argv) -> list:
    from repro_torch.serve.coalesce import SharedWindowRing

    SharedWindowRing.reset()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        serve.main(argv)
    # the first line carries the wall-clock tok/s
    return printed.getvalue().splitlines()[1:]


def test_serve_launcher_sharded_placement_prints_what_local_prints(monkeypatch):
    want = _launch(LAUNCH)
    assert _launch(LAUNCH + ["--placement", "sharded"]) == want
    # and over four row blocks of the 5-request banks
    monkeypatch.setattr(serve, "_data_mesh", lambda device: meshlib.make_test_mesh((4,), ("data",), device))
    assert _launch(LAUNCH + ["--placement", "sharded"]) == want


# ----------------------------------------------------------------------------
# the card (the placement phase's checks of chip_smoke.py, at a small size)
# ----------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("carrier", ["bank", "hybrid", "window", "countmin", "sketch"])
def test_placements_on_card_match_local(carrier):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    mesh = meshlib.make_auto_mesh((4,), ("data",), [dev] * 4)
    for backend in ("cuda", "cuda_pipelined"):
        local = ExecutionPlan(backend=backend)
        plans = (local.with_mesh(mesh), local.with_sharding(mesh))
        keys, items = _stream(70, n=1 << 16, zipf=True)
        k, x = torch.from_numpy(keys).to(dev), torch.from_numpy(items).to(dev)
        if carrier == "bank":
            def run(plan):
                bank = SketchBank.empty(ROWS, HLLConfig(p=16, hash_bits=64), dev).update_many(k, x, plan)
                return bank.to_bytes(), bank.estimate_many(plan=plan).cpu()
        elif carrier == "hybrid":
            def run(plan):
                bank = HybridBank.empty(ROWS, HLLConfig(p=10, hash_bits=64), device=dev).update_many(k, x, plan)
                return bank.to_bytes(), bank.estimate_many(plan=plan).cpu()
        elif carrier == "window":
            def run(plan):
                ring = WindowedBank.empty(4, ROWS, CFG, dev)
                for part in range(6):
                    ring = (ring.advance() if part else ring).observe(k[part::6], x[part::6], plan)
                return ring.to_bytes(), torch.stack([ring.estimate_window(j, plan) for j in (None, 1)]).cpu()
        elif carrier == "countmin":
            def run(plan):
                bank = CountMinBank.empty(ROWS, CMConfig(4, 1024), device=dev).update_many(k, x, plan)
                return bank.to_bytes(), bank.query(x[:64], plan).cpu()
        else:
            def run(plan):
                sk = HyperLogLog.empty(HLLConfig(p=16, hash_bits=64), dev).update(x, plan)
                return sk.to_bytes(), torch.tensor([sk.estimate()])
        want_bytes, want_est = run(local)
        for plan in plans:
            got_bytes, got_est = run(plan)
            assert got_bytes == want_bytes, (carrier, backend, plan.placement)
            assert torch.equal(got_est, want_est), (carrier, backend, plan.placement)
