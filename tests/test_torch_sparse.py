"""Port vs reference: HybridBank (sparse rows, append log, promotion, RHLB v2).

* A seeded keyed stream, in chunks with reads between them, through the
  port's ``torch`` and ``cuda`` plans (on the CPU the kernel wrappers run
  their plain versions) and the reference's ``jnp`` plan: the settled
  state -- pairs, ``pair_len``, dense block, slot map, counters -- and the
  RHLB v2 bytes are bit-identical, and so are the host estimates.
* Promotion at threshold - 1, threshold and threshold + 1 distinct buckets.
* The append log defers exactly as the reference's, including the
  pressure policy (floors shrunk by monkeypatch in both packages).
* ``merge`` with dense mode infectious; RHLB v2 bytes in both directions;
  v1 blobs parse as all-dense; ``SketchBank.density`` / ``to_hybrid``.
* Both layouts of the ``torch`` sparse dedup against the reference's jnp
  sort and scatter.
* Device estimates: the reference's within rtol 1e-6 (the bound of
  tests/test_torch_estimators.py).  The sparse LC fast path against the
  port's own dense path within 2 float32 ulps on the CPU, because ATen's
  CPU ``log`` takes a vectorized path for most elements and a scalar one
  for a tensor's tail, which differ in the last ulp -- the same value
  logs differently at different positions.  On the card ``torch.log`` is
  one elementwise function, and ``chip_smoke.py`` holds the two bit for
  bit.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.sketch import ExecutionPlan as RefPlan
from repro.sketch import HybridBank as RefHybrid
from repro.sketch import SketchBank as RefBank
from repro.sketch import sparse as ref_sparse
from repro.sketch.backends import sparse_merge_cells, sparse_merge_sorted as ref_merge_sorted
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch import interop
from repro_torch.sketch import (
    ExecutionPlan,
    HLLConfig,
    HybridBank,
    SketchBank,
    available_sparse_backends,
    dedup_pairs,
    default_threshold,
    get_sparse_backend,
    hash_index_rank,
)
from repro_torch.sketch import sparse
from repro_torch.sketch.backends import _SPARSE_CELLS_CROSSOVER, sparse_merge_sorted

DEVICE_RTOL = 1e-6  # the estimator bound (tests/test_torch_estimators.py)
LC_RTOL = 2.5e-7  # 2 float32 ulps: ATen's CPU log, vectorized body vs scalar tail
PORT_PLANS = ("torch", "cuda", "cuda_pipelined")


def _zipf_stream(rows, n, seed):
    """Keyed stream where 10 % of the rows take 90 % of the items, with
    foreign keys (-1, B) mixed in -- the traffic of benchmarks/bench_sparse.py."""
    rng = np.random.default_rng(seed)
    hot = max(1, rows // 10)
    keys = np.where(rng.random(n) < 0.9, rng.integers(0, hot, n), rng.integers(hot, rows, n))
    keys = keys.astype(np.int32)
    keys[:2] = [-1, rows]
    return keys, rng.integers(0, 2**31, n, dtype=np.int32)


def _assert_same_state(bank: HybridBank, ref: RefHybrid):
    np.testing.assert_array_equal(bank.pairs.numpy(), np.asarray(ref.pairs))
    np.testing.assert_array_equal(bank.sparse_len.numpy(), np.asarray(ref.sparse_len))
    np.testing.assert_array_equal(bank.dense.numpy(), np.asarray(ref.dense))
    np.testing.assert_array_equal(bank.dense_slot.numpy(), np.asarray(ref.dense_slot))
    np.testing.assert_array_equal(bank.counts, ref.counts)
    np.testing.assert_array_equal(bank.modes, ref.modes)
    assert bank.to_bytes() == ref.to_bytes()


def _ingest(bank, chunks, plan, read_every=2):
    for i, (k, x) in enumerate(chunks):
        bank = bank.update_many(k, x, plan)
        if (i + 1) % read_every == 0:
            bank = bank.compact()
    return bank


@functools.lru_cache(maxsize=None)
def _reference_ingest(rows, p, hash_bits):
    """The chunked stream through the reference's jnp plan (shared by the
    port backends' cases)."""
    keys, items = _zipf_stream(rows, 8 << p, p)  # hot rows promote, cold rows stay sparse
    chunks = list(zip(np.array_split(keys, 5), np.array_split(items, 5)))
    ref = RefHybrid.empty(rows, RefConfig(p=p, hash_bits=hash_bits))
    for i, (k, x) in enumerate(chunks):
        ref = ref.update_many(jnp.asarray(k), jnp.asarray(x), RefPlan(backend="jnp"))
        if (i + 1) % 2 == 0:
            ref = ref.compact()
    return keys, items, chunks, ref


@pytest.mark.parametrize("backend", PORT_PLANS)
@pytest.mark.parametrize("p,hash_bits", [(6, 64), (8, 32), (10, 64)])
def test_chunked_ingest_matches_reference(backend, p, hash_bits):
    rows = 24
    keys, items, chunks, ref = _reference_ingest(rows, p, hash_bits)
    bank = _ingest(HybridBank.empty(rows, HLLConfig(p=p, hash_bits=hash_bits), device="cpu"), chunks,
                   ExecutionPlan(backend=backend))
    assert 0 < bank.dense_rows < rows
    _assert_same_state(bank, ref)
    assert [bank.estimate(i) for i in range(rows)] == [ref.estimate(i) for i in range(rows)]
    np.testing.assert_allclose(bank.estimate_many().numpy(), np.asarray(ref.estimate_many()), rtol=DEVICE_RTOL)
    for name in ("ertl_improved", "ertl_mle"):
        got = bank.estimate_many(name).numpy()
        np.testing.assert_allclose(got, np.asarray(ref.estimate_many(name)), rtol=2e-6 if name == "ertl_mle" else DEVICE_RTOL)
    dense = SketchBank.empty(rows, HLLConfig(p=p, hash_bits=hash_bits), "cpu").update_many(keys, items)
    torch.testing.assert_close(bank.to_dense().registers, dense.registers, rtol=0, atol=0)
    np.testing.assert_allclose(bank.estimate_many().numpy(), dense.estimate_many().numpy(), rtol=LC_RTOL)


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_promotion_exactly_past_the_threshold(delta, backend):
    cfg = HLLConfig(p=6, hash_bits=64)
    threshold = default_threshold(cfg)
    # items that hit exactly threshold + delta distinct buckets of row 0
    idx, _ = hash_index_rank(torch.arange(4000, dtype=torch.int32), cfg)
    first = {}
    for item, bucket in enumerate(idx.tolist()):
        first.setdefault(bucket, item)
    items = np.array(sorted(first.values())[: threshold + delta], dtype=np.int32)
    items = np.concatenate([items, items[:5]])  # repeats change nothing
    keys = np.zeros(items.size, np.int32)
    plan = ExecutionPlan(backend=backend)
    one_by_one = HybridBank.empty(3, cfg, device="cpu")
    for k, x in zip(keys, items):
        one_by_one = one_by_one.update_many(k[None], x[None], plan)
    bulk = HybridBank.empty(3, cfg, device="cpu").update_many(keys, items, plan)
    ref = RefHybrid.empty(3, RefConfig(p=6, hash_bits=64)).update_many(jnp.asarray(keys), jnp.asarray(items))
    for bank in (one_by_one, bulk):
        assert bank.modes[0] == (1 if delta > 0 else 0)
        assert int(bank.sparse_len[0]) == (0 if delta > 0 else threshold + delta)
        _assert_same_state(bank, ref)
    dense = SketchBank.empty(3, cfg, "cpu").update_many(keys, items)
    torch.testing.assert_close(bulk.row(0).registers, dense.registers[0], rtol=0, atol=0)


def test_append_log_defers_like_the_reference(monkeypatch):
    monkeypatch.setattr(sparse, "_FLUSH_MIN_PAIRS", 600)
    monkeypatch.setattr(ref_sparse, "_FLUSH_MIN_PAIRS", 600)
    rows = 12
    keys, items = _zipf_stream(rows, 4000, 3)
    bank = HybridBank.empty(rows, HLLConfig(p=8, hash_bits=64), device="cpu")
    ref = RefHybrid.empty(rows, RefConfig(p=8, hash_bits=64))
    for k, x in zip(np.array_split(keys, 16), np.array_split(items, 16)):
        bank = bank.update_many(k, x, ExecutionPlan(backend="cuda"))
        ref = ref.update_many(jnp.asarray(k), jnp.asarray(x))
        assert bank.pending_pairs == ref.pending_pairs
        assert (bank.pending is None) == (ref.pending is None)
        np.testing.assert_array_equal(bank.counts, ref.counts)  # counters never wait
    _assert_same_state(bank, ref)
    empty = bank.update_many(np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert empty is bank


def test_merge_is_dense_infectious_and_matches_reference():
    rows, cfg, rcfg = 16, HLLConfig(p=7, hash_bits=32), RefConfig(p=7, hash_bits=32)
    (ka, xa), (kb, xb) = _zipf_stream(rows, 3000, 11), _zipf_stream(rows, 2500, 12)
    kb = (kb + 5) % rows  # different hot rows on the two sides
    a = HybridBank.empty(rows, cfg, device="cpu").update_many(ka, xa)
    b = HybridBank.empty(rows, cfg, device="cpu").update_many(kb, xb)
    ra = RefHybrid.empty(rows, rcfg).update_many(jnp.asarray(ka), jnp.asarray(xa))
    rb = RefHybrid.empty(rows, rcfg).update_many(jnp.asarray(kb), jnp.asarray(xb))
    for plan in ("torch", "cuda"):
        merged = a.merge(b, ExecutionPlan(backend=plan))
        _assert_same_state(merged, ra.merge(rb))
        assert (merged.modes >= np.maximum(a.modes, b.modes)).all()
    assert (a | b).to_bytes() == (b | a).to_bytes()
    with pytest.raises(ValueError, match="thresholds"):
        a.merge(HybridBank.empty(rows, cfg, threshold=3, device="cpu"))


def test_rhlb_v2_bytes_cross_in_both_directions():
    rows = 10
    keys, items = _zipf_stream(rows, 2500, 21)
    cfg, rcfg = HLLConfig(p=8, hash_bits=64, seed=5), RefConfig(p=8, hash_bits=64, seed=5)
    bank = HybridBank.empty(rows, cfg, threshold=40, device="cpu").update_many(keys, items)
    ref = RefHybrid.empty(rows, rcfg, threshold=40).update_many(jnp.asarray(keys), jnp.asarray(items))
    blob = bank.to_bytes()
    assert RefHybrid.from_bytes(blob).to_bytes() == blob == ref.to_bytes()
    back = HybridBank.from_bytes(ref.to_bytes(), device="cpu")
    _assert_same_state(back, ref)
    # v1 dense blobs parse as all-dense; SketchBank still refuses v2
    v1 = RefBank.empty(rows, rcfg).update_many(jnp.asarray(keys), jnp.asarray(items)).to_bytes()
    all_dense = HybridBank.from_bytes(v1, device="cpu")
    assert all_dense.modes.all() and all_dense.to_bytes() == RefHybrid.from_bytes(v1).to_bytes()
    with pytest.raises(ValueError, match="HybridBank.from_bytes"):
        SketchBank.from_bytes(blob, device="cpu")
    for cut in (3, 30, 60, len(blob) - 1):
        with pytest.raises(ValueError):
            HybridBank.from_bytes(blob[:cut], device="cpu")


def test_density_to_hybrid_and_interop_match_reference():
    rows = 14
    keys, items = _zipf_stream(rows, 2000, 31)
    cfg, rcfg = HLLConfig(p=8, hash_bits=64), RefConfig(p=8, hash_bits=64)
    dense = SketchBank.empty(rows, cfg, "cpu").update_many(keys, items)
    ref_dense = RefBank.empty(rows, rcfg).update_many(jnp.asarray(keys), jnp.asarray(items))
    assert dense.density() == ref_dense.density()
    force = np.arange(rows) % 5 == 0
    hyb, ref_hyb = dense.to_hybrid(dense_rows=force), ref_dense.to_hybrid(dense_rows=force)
    _assert_same_state(hyb, ref_hyb)
    assert hyb.density() == ref_hyb.density() and hyb.nbytes == ref_hyb.nbytes
    state = interop.hybrid_to_reference_state(hyb)
    rebuilt = RefHybrid(**{k: jnp.asarray(v) for k, v in state.items() if k != "threshold"},
                        cfg=rcfg, threshold=state["threshold"])
    assert rebuilt.to_bytes() == hyb.to_bytes()
    back = interop.hybrid_from_reference_state(
        {"pair_buf": ref_hyb.pairs, "pair_len": ref_hyb.sparse_len, "dense_block": ref_hyb.dense,
         "slot_map": ref_hyb.dense_slot, "n_items": ref_hyb.n_items, "threshold": ref_hyb.threshold},
        8, 64, device="cpu")
    _assert_same_state(back, ref_hyb)


@pytest.mark.parametrize("n", [40, 3000])  # both sides of the crossover at rows*m = 8*512
def test_torch_dedup_layouts_match_reference(n):
    rows, cfg = 8, HLLConfig(p=9, hash_bits=64)
    rng = np.random.default_rng(n)
    row = rng.integers(-1, rows + 1, n).astype(np.int32)
    idx, rank = hash_index_rank(torch.from_numpy(rng.integers(0, 2**31, n, dtype=np.int32)), cfg)
    args = (torch.from_numpy(row), idx, rank, rows, cfg, ExecutionPlan(backend="torch"))
    dd = get_sparse_backend("torch")(*args)
    ref_args = (jnp.asarray(row), jnp.asarray(idx.numpy()), jnp.asarray(rank.numpy()))
    if n * _SPARSE_CELLS_CROSSOVER >= rows * cfg.m:
        cells, distinct = sparse_merge_cells(*ref_args, rows=rows, m=cfg.m)
        np.testing.assert_array_equal(dd.cells.numpy(), np.asarray(cells))
    else:
        assert dd.cells is None
        cell_s, rank_s, survivor, distinct = ref_merge_sorted(*ref_args, rows=rows, m=cfg.m)
        np.testing.assert_array_equal(dd.cell_s.numpy(), np.asarray(cell_s))
        np.testing.assert_array_equal(dd.rank_s.numpy(), np.asarray(rank_s))
        np.testing.assert_array_equal(dd.survivor.numpy(), np.asarray(survivor))
    np.testing.assert_array_equal(dd.distinct.numpy(), np.asarray(distinct))
    # every registered entry dedups the same stream to the same distinct counts
    for name in available_sparse_backends():
        other = dedup_pairs(*args[:5], ExecutionPlan(backend=name))
        np.testing.assert_array_equal(other.distinct.numpy(), dd.distinct.numpy())
    assert set(available_sparse_backends()) >= {"torch", "cuda", "cuda_pipelined"}
    empty = sparse_merge_sorted(*(torch.zeros(0, dtype=torch.int32) for _ in range(3)), rows, cfg.m)
    assert empty[0].shape == (0,) and int(empty[3].sum()) == 0


def test_validation_matches_reference_messages():
    cfg = HLLConfig(p=16, hash_bits=64)
    with pytest.raises(ValueError, match="sparse threshold must be in"):
        HybridBank.empty(2, cfg, threshold=cfg.m, device="cpu")
    big = HybridBank.empty(1 << 15, cfg, device="cpu")
    with pytest.raises(ValueError) as got:
        big.update_many(np.zeros(1, np.int32), np.zeros(1, np.int32))
    with pytest.raises(ValueError) as want:
        RefHybrid.empty(1 << 15, RefConfig(p=16, hash_bits=64)).update_many(
            jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32))
    assert str(got.value) == str(want.value)
    with pytest.raises(IndexError):
        HybridBank.empty(2, cfg, device="cpu").row(2)
