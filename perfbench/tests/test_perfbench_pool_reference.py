"""The generator's pools, and the reference against the port's CPU path."""

import hashlib

import numpy as np
import pytest
import torch

from perfbench import pool as poollib
from perfbench.reference import hll as ref_hll
from perfbench.reference import murmur3 as ref_murmur3
from perfbench.reference import sketch_bank as ref_bank
from perfbench.tests.conftest import WORKLOADS, small_cell

CPU = torch.device("cpu")
BIG_SEED = 2**31 + 977


@pytest.mark.parametrize("workload", WORKLOADS)
def test_same_seed_same_pool_other_seed_other_pool(workload):
    cell = small_cell(workload)
    a = poollib.make(cell.config, cell.traffic, BIG_SEED, CPU)
    b = poollib.make(cell.config, cell.traffic, BIG_SEED, CPU)
    c = poollib.make(cell.config, cell.traffic, BIG_SEED + 1, CPU)
    assert len(a) == cell.traffic["pool_items"] // cell.traffic["call_items"]
    for x, y, z in zip(a, b, c):
        assert set(x) == set(y) and x["items"].dtype == torch.int32
        assert x["items"].shape == (cell.traffic["call_items"],)
        for key in x:
            assert torch.equal(x[key], y[key])
        assert not torch.equal(x["items"], z["items"])
        if "keys" in x:
            assert int(x["keys"].min()) >= 0 and int(x["keys"].max()) < cell.config["rows"]


# sha256 of each existing cell's small pool on the CPU (batches in order, each
# batch's tensors by name), as the generator drew them before it took hot keys:
# a traffic file without them draws the same pool
POOL_DIGESTS = {
    ("nic_stream.bulk", 7): "eede9baacba6fcc5004cf31fdbed5e86",
    ("nic_stream.bulk", BIG_SEED): "ae93ccb888ff06ca0ba64fb52673a14b",
    ("tenant_fleet.ingest", 7): "d7aac4f3af00df9d4536e06f916ef128",
    ("tenant_fleet.ingest", BIG_SEED): "fc2eb52d22277e1f7467f9cfad32f363",
    ("tenant_fleet.dashboard", 7): "d7aac4f3af00df9d4536e06f916ef128",
    ("tenant_fleet.dashboard", BIG_SEED): "fc2eb52d22277e1f7467f9cfad32f363",
}


def _digest(batches) -> str:
    h = hashlib.sha256()
    for batch in batches:
        for name in sorted(batch):
            h.update(name.encode())
            h.update(batch[name].contiguous().numpy().tobytes())
    return h.hexdigest()[:32]


@pytest.mark.parametrize("workload,seed", sorted(POOL_DIGESTS))
def test_existing_pools_are_pinned(workload, seed):
    cell = small_cell(workload)
    assert _digest(poollib.make(cell.config, cell.traffic, seed, CPU)) == POOL_DIGESTS[workload, seed]


def _one_batch(config, traffic, seed=5):
    n = traffic["pool_items"]
    (batch,) = poollib.make(config, {"call_items": n, **traffic}, seed, CPU)
    return batch


def test_an_item_draw_other_than_uniform_is_refused():
    with pytest.raises(ValueError, match="uniform 32-bit words"):
        _one_batch({}, {"pool_items": 1 << 10, "items": {"dist": "zipf", "a": 1.1}})


def test_hot_keys_take_their_share():
    rows = 1000
    keys = _one_batch({"rows": rows}, {"pool_items": 1 << 20,
                                       "keys": {"dist": "hot", "frac": 0.1, "share": 0.9}})["keys"]
    assert keys.dtype == torch.int32 and int(keys.min()) >= 0 and int(keys.max()) < rows
    counts = np.bincount(keys.numpy(), minlength=rows)
    assert abs(counts[:100].sum() / keys.numel() - 0.9) < 0.005
    # uniform within each group
    assert counts[:100].min() > 0.8 * counts[:100].mean() and counts[100:].min() > 0.5 * counts[100:].mean()


def test_zipf_mod_cdf_is_the_folded_zipf():
    a, rows, terms = 1.2, 16, 200_000
    k = np.arange(rows, dtype=np.float64)[:, None]
    t = np.arange(terms, dtype=np.float64)[None, :]
    # each residue class's sum, with the integral of its tail beyond `terms`
    # (taken from the midpoint: the error is far below the tolerance)
    head = ((k + 1 + rows * t) ** -a).sum(axis=1)
    tail = (k[:, 0] + 1 + rows * (terms - 0.5)) ** (1 - a) / (rows * (a - 1))
    direct = head + tail
    cdf = poollib.zipf_mod_cdf(a, rows).numpy()
    assert np.allclose(np.diff(cdf, prepend=0.0), direct / direct.sum(), rtol=1e-6)


def test_zipf_keys_follow_their_cdf():
    keys = poollib.make({"rows": 1024}, {"pool_items": 1 << 20, "call_items": 1 << 20,
                                         "keys": {"dist": "zipf", "a": 1.2}}, 5, CPU)[0]["keys"]
    share = np.bincount(keys.numpy(), minlength=1024) / keys.numel()
    want = np.diff(poollib.zipf_mod_cdf(1.2, 1024).numpy(), prepend=0.0)
    assert abs(share[0] - want[0]) < 0.005 and abs(share[:10].sum() - want[:10].sum()) < 0.005


def test_murmur3_matches_the_published_vectors():
    from repro_torch.sketch import murmur3 as port

    items = torch.tensor([0, 1, 2, 0x7FFFFFFF, -1, -2**31, 123456789], dtype=torch.int32)
    for seed in (0, 42, 2**63 + 5):
        want64 = [port.murmur3_64_py(int(v) & 0xFFFFFFFF, seed) for v in items]
        want32 = [port.murmur3_32_py(int(v) & 0xFFFFFFFF, seed) for v in items]
        got64 = [int(v) & ref_murmur3.M64 for v in ref_murmur3.hash64(items, seed)]
        assert got64 == want64
        assert [int(v) for v in ref_murmur3.hash32(items, seed)] == want32


@pytest.mark.parametrize("hash_bits", [32, 64])
@pytest.mark.parametrize("p", [4, 10, 16])
def test_index_rank_agrees_with_the_port(p, hash_bits):
    from repro_torch.sketch import HLLConfig, hll

    items = torch.randint(-2**31, 2**31, (1 << 14,), dtype=torch.int32, generator=torch.Generator().manual_seed(p))
    cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=7)
    idx, rank = ref_hll.index_rank(items, p, hash_bits, 7)
    want_idx, want_rank = hll.hash_index_rank(items, cfg)
    assert torch.equal(idx, want_idx.to(torch.int64)) and torch.equal(rank, want_rank)


def test_stream_reference_agrees_with_the_port_cpu_path():
    from repro_torch.sketch import HLLConfig, HyperLogLog
    from perfbench.reference import hll_stream

    cell = small_cell("nic_stream.bulk")
    batches = poollib.make(cell.config, cell.traffic, 11, CPU)
    n = len(batches)
    calls = n + 3
    got = {}
    for i in range(calls):
        if i % n == 0:
            if i:
                got["pass"] = {"registers": sk.registers, "count": sk.count}
            sk = HyperLogLog.empty(HLLConfig(p=16, hash_bits=64), CPU)
        sk = sk.update(batches[i % n]["items"])
    got["now"] = {"registers": sk.registers, "count": sk.count}
    want = hll_stream.expected(cell.config, batches, calls)
    assert set(want) == {"now", "pass"} and want["now"]["count"] == 3 * cell.traffic["call_items"]
    assert hll_stream.compare(got, want) == {"registers_differ": 0, "count_gap": 0}


@pytest.mark.parametrize("keys", [{"dist": "zipf", "a": 1.2}, {"dist": "uniform"}])
def test_bank_reference_agrees_with_the_port_cpu_path(keys):
    from repro_torch.sketch import HLLConfig, SketchBank

    cell = small_cell("tenant_fleet.ingest")
    cell.traffic["keys"] = keys
    batches = poollib.make(cell.config, cell.traffic, 12, CPU)
    n = len(batches)
    reads, got = [], {}
    calls = n + 2
    for i in range(calls):
        if i % n == 0:
            if i:
                got["pass"] = {"registers": bank.registers, "counts": bank.counts}
            bank = SketchBank.empty(8, HLLConfig(p=10, hash_bits=64), CPU)
        bank = bank.update_many(batches[i % n]["keys"], batches[i % n]["items"])
        reads.append(bank.estimate_many().numpy())
    got.update(now={"registers": bank.registers, "counts": bank.counts}, reads=np.stack(reads))
    want = ref_bank.expected(cell.config, batches, calls, reads=calls)
    numbers = ref_bank.compare(got, want)
    assert numbers["registers_differ"] == 0 and numbers["counter_rows_differ"] == 0
    assert numbers["estimate_rel_gap"] < 1e-6


def test_estimates_follow_the_original_estimator():
    # one register row per regime: empty, small (linear counting), large
    regs = torch.zeros((3, 1 << 10), dtype=torch.int32)
    regs[1, :100] = 1
    regs[2] = 20
    est = ref_hll.estimates(regs, 10, 64)
    m = 1024
    assert float(est[0]) == 0.0
    assert np.isclose(float(est[1]), m * np.log(m / (m - 100)))
    assert np.isclose(float(est[2]), ref_hll.alpha(m) * m * m / (m * 2.0 ** -20))


def test_control_counters_wrap_at_32_bits():
    cell = small_cell("tenant_fleet.ingest")
    batches = poollib.make(cell.config, cell.traffic, 13, CPU)
    calls = 5 * len(batches)
    exact = ref_bank.expected(cell.config, batches, calls)
    low = ref_bank.expected(cell.config, batches, calls, precision="low")
    for state in ("now", "pass"):
        assert np.array_equal(low[state]["counts"], exact[state]["counts"] % (1 << 32))
    assert ref_bank.compare(low, exact)["registers_differ"] > 0
