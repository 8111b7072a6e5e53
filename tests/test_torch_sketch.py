"""Port vs reference: plans, the single-sketch carrier and set algebra.

* Every ``example_plans()`` plan of the port gives registers bit-identical
  to the reference's ``reference_plan()`` (DESIGN.md §3), for p in
  {4, 8, 12, 16} and H in {32, 64}.
* Carrier merge and set algebra equal the reference's host-exact values.
* RHLL bytes are identical in both directions.
* The exact counter stays exact past 2^32.
* Entry points run on the card unless told otherwise, and plans refuse
  what the port does not do yet rather than degrade.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.sketch import HyperLogLog as RefHLL
from repro.sketch import ExecutionPlan as RefPlan
from repro.sketch import update_registers as ref_update_registers
from repro.sketch import hll as ref_hll
from repro.sketch import reference_plan as ref_reference_plan
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch import interop
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.sketch import (
    DEFAULT_PLAN,
    ExecutionPlan,
    HLLConfig,
    HyperLogLog,
    available_backends,
    example_plans,
    exact,
    hll,
    reference_plan,
    update_registers,
)

CONFIGS = [(p, h) for p in (4, 8, 12, 16) for h in (32, 64)]


def _items(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _ref_regs(items, p, h, seed=0):
    cfg = RefConfig(p=p, hash_bits=h, seed=seed)
    return np.asarray(
        ref_update_registers(ref_hll.init_registers(cfg), jnp.asarray(items), cfg, ref_reference_plan())
    )


def test_backends_and_default_plan():
    assert available_backends() == ("cuda", "cuda_pipelined", "torch")
    assert DEFAULT_PLAN.backend == "cuda"
    assert reference_plan() == ExecutionPlan(backend="torch", pipelines=1)
    fields = [f for f in ExecutionPlan.__dataclass_fields__]
    assert fields == [f for f in RefPlan.__dataclass_fields__]


@pytest.mark.parametrize("p,hash_bits", CONFIGS)
def test_every_example_plan_matches_reference_plan(p, hash_bits):
    items = _items(3001, p * hash_bits)  # divides neither the pipelines nor a tile
    want = _ref_regs(items, p, hash_bits, seed=7)
    cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=7)
    for plan in example_plans():
        got = update_registers(hll.init_registers(cfg, "cpu"), items, cfg, plan)
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(plan))


@pytest.mark.parametrize("p,hash_bits", [(4, 32), (12, 64), (16, 64)])
def test_streamed_updates_match_one_shot_and_reference(p, hash_bits):
    items = _items(5000, p)
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    sk = HyperLogLog.empty(cfg, "cpu")
    for chunk in np.array_split(items, 7):
        sk = sk.update(chunk, ExecutionPlan(backend="cuda_pipelined", pipelines=3))
    ref = RefHLL.empty(RefConfig(p=p, hash_bits=hash_bits))
    for chunk in np.array_split(items, 7):
        ref = ref.update(jnp.asarray(chunk))
    np.testing.assert_array_equal(sk.registers.numpy(), np.asarray(ref.registers))
    assert sk.count == ref.count == items.size
    assert sk.estimate() == ref.estimate()
    assert HyperLogLog.of(torch.from_numpy(items.view(np.int32)), cfg).registers.equal(sk.registers)


def test_empty_stream_is_the_identity():
    sk = HyperLogLog.of(_items(100, 1), HLLConfig(p=8), device="cpu")
    assert sk.update(np.zeros(0, np.uint32)) is sk
    regs = sk.registers
    assert update_registers(regs, torch.zeros(0, dtype=torch.int32), sk.cfg) is regs


@pytest.mark.parametrize("p,hash_bits", CONFIGS)
def test_merge_and_set_algebra_match_reference(p, hash_bits):
    a_items, b_items = _items(4000, 1), _items(3000, 2)
    b_items[:1500] = a_items[:1500]  # overlap
    cfg, rcfg = HLLConfig(p=p, hash_bits=hash_bits), RefConfig(p=p, hash_bits=hash_bits)
    a, b = HyperLogLog.of(a_items, cfg, device="cpu"), HyperLogLog.of(b_items, cfg, device="cpu")
    ra, rb = RefHLL.of(jnp.asarray(a_items), rcfg), RefHLL.of(jnp.asarray(b_items), rcfg)
    u, ru = a | b, ra | rb
    np.testing.assert_array_equal(u.registers.numpy(), np.asarray(ru.registers))
    assert u.count == ru.count == 7000
    for name in ("original", "ertl_improved", "ertl_mle"):
        assert a.union_estimate(b, name) == ra.union_estimate(rb, name)
        assert a.intersection_estimate(b, name) == ra.intersection_estimate(rb, name)
        assert a.difference_estimate(b, name) == ra.difference_estimate(rb, name)
        assert a.jaccard(b, name) == ra.jaccard(rb, name)
    assert a.duplication() == ra.duplication()
    with pytest.raises(ValueError, match="different configs"):
        a.merge(HyperLogLog.empty(HLLConfig(p=p, hash_bits=hash_bits, seed=1), "cpu"))


@pytest.mark.parametrize("p,hash_bits", CONFIGS)
def test_rhll_bytes_identical_in_both_directions(p, hash_bits):
    items = _items(2500, p + hash_bits)
    seed = 2**64 - 1
    sk = HyperLogLog.of(items, HLLConfig(p=p, hash_bits=hash_bits, seed=seed), device="cpu")
    ref = RefHLL.of(jnp.asarray(items), RefConfig(p=p, hash_bits=hash_bits, seed=seed))
    assert sk.to_bytes() == ref.to_bytes()
    # the reference parses the port's blob and the port parses the reference's
    back_ref = RefHLL.from_bytes(sk.to_bytes())
    back = HyperLogLog.from_bytes(ref.to_bytes(), device="cpu")
    np.testing.assert_array_equal(back.registers.numpy(), np.asarray(back_ref.registers))
    assert back.count == back_ref.count == items.size and back.cfg.seed == seed
    for bad, msg in ((b"xx", "truncated"), (b"RHLX" + ref.to_bytes()[4:], "bad magic"),
                     (ref.to_bytes()[:-1], "payload")):
        with pytest.raises(ValueError, match=msg):
            HyperLogLog.from_bytes(bad, device="cpu")


def test_counter_stays_exact_past_2_32():
    cfg = HLLConfig(p=6)
    near = (1 << 32) - 3
    regs = torch.zeros(cfg.m, dtype=torch.uint8)
    a = interop.from_reference_state(regs.numpy(), np.array([0, near], np.uint32), 6, 64, device="cpu")
    b = a.update(_items(10, 3))
    assert b.count == near + 10 and b.n_items.tolist() == [1, 7]
    big = (1 << 63) + 12345
    c = HyperLogLog.from_bytes(RefHLL.from_bytes(b.to_bytes()).to_bytes(), device="cpu")
    d = interop.from_reference_state(regs.numpy(), np.array([big >> 32, big & 0xFFFFFFFF], np.uint32), 6, 64, device="cpu")
    assert (c | d).count == big + near + 10
    # wraps modulo 2^64 like the reference's limb add
    e = interop.from_reference_state(regs.numpy(), np.array([0xFFFFFFFF, 0xFFFFFFFF], np.uint32), 6, 64, device="cpu")
    assert (e | c).count == (near + 10 - 1)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = HLLConfig(p=4)
    for make in (
        lambda: HyperLogLog.empty(cfg),
        lambda: HyperLogLog.of(_items(10, 0), cfg),
        lambda: hll.init_registers(cfg),
        lambda: HyperLogLog.from_bytes(HyperLogLog.empty(cfg, "cpu").to_bytes()),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # a CPU tensor carries its device along
    assert HyperLogLog.of(torch.zeros(3, dtype=torch.int32), cfg).device.type == "cpu"


def test_plan_refuses_what_the_port_does_not_do():
    with pytest.raises(ValueError, match="requires a mesh"):
        ExecutionPlan(placement="mesh")
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="not in mesh axes"):
        ExecutionPlan().with_sharding(mesh, data_axes=("rows",)).validate()
    with pytest.raises(ValueError, match="placement must be one of"):
        ExecutionPlan(placement="nowhere")
    with pytest.raises(ValueError, match="interpret mode"):
        ExecutionPlan(interpret=True)
    with pytest.raises(ValueError, match="pipelines"):
        ExecutionPlan(pipelines=0)
    with pytest.raises(ValueError, match="unknown backend"):
        ExecutionPlan(backend="pallas").validate()


def test_config_validation_and_exact_baselines_match_reference():
    for bad in (dict(p=3), dict(p=17), dict(hash_bits=48), dict(seed=-1), dict(seed=1 << 64)):
        with pytest.raises(ValueError):
            HLLConfig(**bad)
        with pytest.raises(ValueError):
            RefConfig(**bad)
    cfg = HLLConfig(p=10, hash_bits=32)
    assert (cfg.m, cfg.max_rank, cfg.register_bits, cfg.memory_footprint_bits) == (
        1024, 23, 5, 5120)
    items = _items(700, 9)
    from repro.sketch import exact as ref_exact

    bitmap = exact.linear_counting_registers(torch.from_numpy(items.view(np.int32)), cfg)
    ref_bitmap = ref_exact.linear_counting_registers(jnp.asarray(items), RefConfig(p=10, hash_bits=32))
    np.testing.assert_array_equal(bitmap.numpy(), np.asarray(ref_bitmap))
    assert exact.linear_counting_estimate(bitmap, cfg.m) == ref_exact.linear_counting_estimate(
        ref_bitmap, cfg.m)
    assert exact.exact_distinct(items) == ref_exact.exact_distinct(items)
    assert hll.cardinality(torch.from_numpy(items.view(np.int32)), cfg) == ref_hll.cardinality(
        jnp.asarray(items), RefConfig(p=10, hash_bits=32))
