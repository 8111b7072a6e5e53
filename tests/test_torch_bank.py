"""Port vs reference: SketchBank keyed ingestion, counters, RHLB, estimates.

* ``update_many`` under every port bank backend is bit-identical to the
  reference's ``jnp`` and ``pallas`` bank backends (the latter where its
  VMEM cap allows, p <= 12), registers and counters, for p in
  {4, 8, 12, 16} and H in {32, 64}.
* Keys outside [0, B) leave no trace (the §9 drop rule).
* The B*m guard raises the reference's message.
* RHLB bytes cross in both directions; ``interop`` round-trips state.
* ``estimate_many`` stays within the bound stated in
  tests/test_torch_estimators.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.sketch import ExecutionPlan as RefPlan
from repro.sketch import SketchBank as RefBank
from repro.sketch.backends import bank_update_jnp
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch import interop
from repro_torch.sketch import (
    ExecutionPlan,
    HLLConfig,
    HyperLogLog,
    SketchBank,
    available_bank_backends,
    update_bank_registers,
    update_many,
)
from repro_torch.sketch.backends import bank_update, bank_update_torch

CONFIGS = [(p, h) for p in (4, 8, 12, 16) for h in (32, 64)]
DEVICE_RTOL = 1e-6  # the estimator bound (tests/test_torch_estimators.py)


def _stream(n, rows, seed):
    """Keys with foreign values mixed in (-1, B, beyond) and int32 items."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2, rows + 2, n).astype(np.int32)
    keys[:3] = [-1, rows, 2**31 - 1]
    items = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    return keys, items


def _ref_bank(rows, p, h, keys_chunks, items_chunks, backend):
    bank = RefBank.empty(rows, RefConfig(p=p, hash_bits=h))
    for k, x in zip(keys_chunks, items_chunks):
        bank = bank.update_many(jnp.asarray(k), jnp.asarray(x), RefPlan(backend=backend))
    return bank


@pytest.mark.parametrize("p,hash_bits", CONFIGS)
def test_update_many_matches_reference_bank_backends(p, hash_bits):
    rows = 37 if p < 12 else 5
    keys, items = _stream(4000, rows, p + hash_bits)
    kc, xc = np.array_split(keys, 3), np.array_split(items, 3)
    want = _ref_bank(rows, p, hash_bits, kc, xc, "jnp")
    if p <= 12:  # the reference's pallas bank path stops at m <= 4096
        pallas = _ref_bank(rows, p, hash_bits, kc, xc, "pallas")
        np.testing.assert_array_equal(np.asarray(pallas.registers), np.asarray(want.registers))
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    for backend in available_bank_backends():
        bank = SketchBank.empty(rows, cfg, device="cpu")
        for k, x in zip(kc, xc):
            bank = update_many(bank, k, x, ExecutionPlan(backend=backend))
        regs, limbs = interop.to_reference_state(bank)
        np.testing.assert_array_equal(regs, np.asarray(want.registers), err_msg=backend)
        np.testing.assert_array_equal(limbs, np.asarray(want.n_items), err_msg=backend)
        np.testing.assert_array_equal(bank.counts, want.counts)


def test_dropped_keys_leave_no_trace():
    rows, cfg = 6, HLLConfig(p=8)
    keys, items = _stream(3000, rows, 1)
    valid = (keys >= 0) & (keys < rows)
    for backend in available_bank_backends():
        plan = ExecutionPlan(backend=backend)
        got = SketchBank.empty(rows, cfg, "cpu").update_many(keys, items, plan)
        clean = SketchBank.empty(rows, cfg, "cpu").update_many(keys[valid], items[valid], plan)
        assert got.registers.equal(clean.registers) and np.array_equal(got.counts, clean.counts)
        assert int(got.counts.sum()) == int(valid.sum())
    # and the bank equals the per-sketch loop, row by row
    for b in range(rows):
        row = HyperLogLog.of(items[keys == b], cfg, device="cpu")
        assert got.row(b).registers.equal(row.registers) and got.row(b).count == row.count


def test_cell_space_guard_matches_reference_message():
    cfg = HLLConfig(p=16)
    big = torch.empty((1 << 15, cfg.m), dtype=torch.uint8, device="meta")  # B*m == 2^31
    keys = items = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError) as ref_err:
        jax.eval_shape(
            lambda r, k, x: bank_update_jnp(r, k, x, RefConfig(p=16)),
            jax.ShapeDtypeStruct(tuple(big.shape), jnp.uint8),
            jax.ShapeDtypeStruct((8,), jnp.int32),
            jax.ShapeDtypeStruct((8,), jnp.int32),
        )
    for fn in (bank_update_torch, bank_update):
        with pytest.raises(ValueError) as err:
            fn(big, keys, items, cfg)
        assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("p,hash_bits", [(4, 64), (12, 32), (16, 64)])
def test_rhlb_bytes_cross_in_both_directions(p, hash_bits):
    rows = 9
    keys, items = _stream(3000, rows, p)
    cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=2**40 + 3)
    bank = SketchBank.empty(rows, cfg, "cpu").update_many(keys, items)
    ref = RefBank.empty(rows, RefConfig(p=p, hash_bits=hash_bits, seed=2**40 + 3)).update_many(
        jnp.asarray(keys), jnp.asarray(items)
    )
    assert bank.to_bytes() == ref.to_bytes()
    back = SketchBank.from_bytes(ref.to_bytes(), device="cpu")
    back_ref = RefBank.from_bytes(bank.to_bytes())
    np.testing.assert_array_equal(back.registers.numpy(), np.asarray(back_ref.registers))
    np.testing.assert_array_equal(back.counts, back_ref.counts)
    assert back.cfg.seed == cfg.seed
    for bad, msg in ((b"RHLB", "truncated"), (b"NOPE" + ref.to_bytes()[4:], "bad magic"),
                     (ref.to_bytes() + b"\0", "payload")):
        with pytest.raises(ValueError, match=msg):
            SketchBank.from_bytes(bad, device="cpu")


@pytest.mark.parametrize("p,hash_bits", [(8, 32), (12, 64), (16, 32)])
def test_estimate_many_matches_reference(p, hash_bits):
    rows = 7
    keys, items = _stream(20_000, rows, 5)
    bank = SketchBank.empty(rows, HLLConfig(p=p, hash_bits=hash_bits), "cpu").update_many(keys, items)
    ref = RefBank.empty(rows, RefConfig(p=p, hash_bits=hash_bits)).update_many(
        jnp.asarray(keys), jnp.asarray(items)
    )
    for name in ("original", "ertl_improved"):
        got = bank.estimate_many(name)
        assert got.dtype == torch.float32 and got.shape == (rows,)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.estimate_many(name)), rtol=DEVICE_RTOL)
        assert bank.estimate(3, name) == ref.estimate(3, name)
    plan = ExecutionPlan(estimator="ertl_improved")
    np.testing.assert_array_equal(bank.estimate_many(plan=plan).numpy(),
                                  bank.estimate_many("ertl_improved").numpy())


def test_interop_round_trips_state():
    rows = 4
    keys, items = _stream(2000, rows, 8)
    ref = RefBank.empty(rows, RefConfig(p=6, hash_bits=32, seed=11)).update_many(
        jnp.asarray(keys), jnp.asarray(items)
    )
    bank = interop.from_reference_state(np.asarray(ref.registers), np.asarray(ref.n_items), 6, 32, 11, "cpu")
    assert isinstance(bank, SketchBank) and bank.to_bytes() == ref.to_bytes()
    regs, limbs = interop.to_reference_state(bank)
    assert regs.dtype == np.uint8 and limbs.dtype == np.uint32
    np.testing.assert_array_equal(limbs, np.asarray(ref.n_items))
    row = interop.from_reference_state(regs[2], limbs[2], 6, 32, 11, "cpu")
    assert isinstance(row, HyperLogLog) and row.to_bytes() == ref.row(2).to_bytes()
    with pytest.raises(ValueError, match="counter limbs"):
        interop.from_reference_state(regs, limbs[:2], 6, 32, 11, "cpu")


def test_bank_construction_merge_and_validation():
    cfg = HLLConfig(p=5)
    with pytest.raises(ValueError, match="at least one row"):
        SketchBank.empty(0, cfg, "cpu")
    with pytest.raises(ValueError, match="at least one sketch"):
        SketchBank.from_sketches([])
    keys, items = _stream(1000, 3, 2)
    a = SketchBank.empty(3, cfg, "cpu").update_many(keys, items)
    b = SketchBank.from_sketches([HyperLogLog.of(items[:300], cfg, device="cpu")] * 3)
    ab = a | b
    assert np.array_equal(ab.counts, a.counts + b.counts)
    assert ab.registers.equal(torch.maximum(a.registers, b.registers))
    with pytest.raises(ValueError, match="different sizes"):
        a.merge(SketchBank.empty(4, cfg, "cpu"))
    with pytest.raises(ValueError, match="same length"):
        a.update_many(keys[:5], items[:6])
    with pytest.raises(IndexError):
        a.row(3)
    assert a.update_many(keys[:0], items[:0]) is a
    regs = a.registers
    assert update_bank_registers(regs, keys[:0], items[:0], cfg) is regs
