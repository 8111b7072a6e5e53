"""bank_row_count: the exact per-row counters of a keyed tick.

On the CPU the wrapper runs its plain version (``bincount`` of the routed
keys, then ``u64.add``).  These tests hold it to exact Python integers on
dropped, negative and out-of-range keys, one row taking every key, and
carries across 2^32 and the wrap at 2^64; hold a plain model of the
kernel's decomposition (per-block uint32 histograms, or per-block tables
of hot keys with the overflow added directly, over the slices
``count_split`` plans, a uint64 scratch, the carry into limbs in 64-bit
two's complement) to the plain version; and test the path rule at its
boundary and the ``meta`` path.

The ``gpu`` tests hold the kernel to its plain version on the card on
Zipf(1.2) and adversarial streams, alone and through ``SketchBank``,
``HybridBank`` and ``CountMinBank``, and check that it reads nothing back
to the host.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import bank_count, launch_counts
from repro_torch.kernels.bank_count import (
    BLOCKS_PER_SM,
    SHARED_ROWS,
    TALLY_HASH,
    TALLY_PROBES,
    TALLY_SLOTS,
    bank_count_path,
    bank_row_count,
    bank_row_count_plain,
    count_split,
)
from repro_torch.obs import costs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sketch import u64

MASK32, MASK64 = (1 << 32) - 1, (1 << 64) - 1
SHARED_BYTES_PER_SM = 232_448  # the shared memory an H100 SM gives its blocks


def _exact(limbs: torch.Tensor, keys: np.ndarray) -> np.ndarray:
    """The new limbs from Python integers: (old + count) mod 2^64."""
    out = []
    for r, (hi, lo) in enumerate(limbs.tolist()):
        total = (((hi << 32) | lo) + int(np.count_nonzero(keys == r))) & MASK64
        out.append([total >> 32, total & MASK32])
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def _limbs(values) -> torch.Tensor:
    return torch.tensor([[v >> 32, v & MASK32] for v in values], dtype=torch.int64).reshape(-1, 2)


def _streams(rows: int, n: int, seed: int) -> dict:
    """{name: (limbs, keys)}: the plain version's hard cases at ``rows`` rows."""
    rng = np.random.default_rng(seed)
    zipf = ((rng.zipf(1.2, n) - 1) % rows).astype(np.int32)
    foreign = rng.integers(-3, rows + 3, n).astype(np.int32)
    foreign[:4] = [-1, rows, np.iinfo(np.int32).min, np.iinfo(np.int32).max][: min(n, 4)]
    counts = rng.integers(0, 1 << 40, rows).tolist()
    return {
        "zipf": (_limbs(counts), zipf),
        "foreign keys": (_limbs(counts), foreign),
        "one row takes every key": (_limbs(counts), np.full(n, rows - 1, np.int32)),
        "every key dropped": (_limbs(counts), np.where(foreign < 0, foreign, foreign + rows).astype(np.int32)),
        "lo limbs carry across 2^32": (_limbs([MASK32 - (r % 3) for r in range(rows)]), zipf),
        "wrap at 2^64": (_limbs([MASK64 - (r % 5) for r in range(rows)]), foreign),
        "empty stream": (_limbs(counts), np.zeros(0, np.int32)),
    }


CASES = [(rows, n, name) for rows, n in ((1, 7), (5, 1000), (1024, 40_000)) for name in _streams(1, 1, 0)]


@pytest.mark.parametrize("rows,n,name", CASES)
def test_plain_matches_the_old_counters_and_exact_integers(rows, n, name):
    limbs, keys = _streams(rows, n, rows + n)[name]
    before = limbs.clone()
    got = bank_row_count(limbs, torch.from_numpy(keys))
    assert got.dtype == torch.int64 and got.shape == (rows, 2)
    np.testing.assert_array_equal(got.numpy(), _exact(limbs, keys))
    assert torch.equal(limbs, before)  # a value: the input limbs are never written
    assert launch_counts()["bank_row_count"] == 0


def _tally(part: np.ndarray, scratch: np.ndarray) -> np.ndarray:
    """The global path's table for one block's valid keys, in the order
    given: each key probes TALLY_PROBES slots from its hash, takes the first
    that holds it or is free, or is added to ``scratch`` directly.  Returns
    the slots' counts added to a (rows,) array."""
    slot_key = np.full(TALLY_SLOTS, -1, np.int64)
    slot_count = np.zeros(TALLY_SLOTS, np.uint64)
    shift = 32 - (TALLY_SLOTS.bit_length() - 1)
    for key in part.tolist():
        s = ((key * TALLY_HASH) & MASK32) >> shift
        for _ in range(TALLY_PROBES):
            if slot_key[s] in (-1, key):
                slot_key[s] = key
                slot_count[s] += 1
                break
            s = (s + 1) % TALLY_SLOTS
        else:
            scratch[key] += 1
    held = slot_key >= 0
    return np.bincount(slot_key[held], weights=slot_count[held], minlength=scratch.size).astype(np.uint64)


def _decomposition(limbs: torch.Tensor, keys: np.ndarray, sms: int) -> np.ndarray:
    """csrc/bank_count.cu's arithmetic in numpy: a uint32 histogram a block
    (the shared path) or a table of hot keys a block (the global path) over
    the slices ``count_split`` plans, every block's counts added into a
    uint64 scratch, and u64.add's steps in 64-bit two's complement."""
    rows, n = limbs.shape[0], keys.size
    per, blocks = count_split(n, rows, sms)
    assert per % 4 == 0 and per * blocks >= n > (blocks - 1) * per
    scratch = np.zeros(rows, dtype=np.uint64)
    for b in range(blocks):
        part = keys[b * per: (b + 1) * per]
        part = part[(part >= 0) & (part < rows)]
        if bank_count_path(rows) == "shared":
            bins = np.bincount(part, minlength=rows)
        else:
            bins = _tally(part, scratch)
        assert bins.max(initial=0) < 1 << 32  # the shared bins and slots are uint32
        scratch += bins.astype(np.uint32).astype(np.uint64)
    a = limbs.numpy().astype(np.uint64)
    with np.errstate(over="ignore"):
        lo = (a[:, 1] + (scratch & np.uint64(MASK32))).view(np.int64)
        hi = a[:, 0] + (scratch >> np.uint64(32)) + (lo >> 32).view(np.uint64)  # arithmetic shift, as int64 >>
    return np.stack([(hi & np.uint64(MASK32)).view(np.int64), lo & MASK32], axis=1)


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("rows,n", [(1, 5), (7, 8193), (1024, 1 << 16), (1024, 3 * (1 << 15) + 3),
                                    (SHARED_ROWS, 1 << 17), (SHARED_ROWS + 1, 1 << 15)])
def test_kernel_decomposition_matches_plain(rows, n, sms):
    rng = np.random.default_rng(rows * 7 + n)
    keys = rng.integers(-2, rows + 2, n).astype(np.int32)
    keys[rng.random(n) < 0.2] = 0  # a hot row, as Zipf(1.2) keys make one
    limbs = _limbs([(MASK64 - r) if r % 2 else (MASK32 - r) for r in range(rows)])
    want = bank_row_count_plain(limbs, torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(_decomposition(limbs, keys, sms), want)


def test_global_tally_keeps_the_hot_row_in_shared_memory():
    # a block's slice of Zipf(1.2) keys over 2^20 rows: the hot row takes a
    # slot and every one of its adds; the keys left over spread over rows
    rng = np.random.default_rng(1 << 20)
    keys = (rng.zipf(1.2, 1 << 15) - 1) % (1 << 20)
    scratch = np.zeros(1 << 20, np.uint64)
    bins = _tally(keys, scratch)
    assert bins[0] == np.count_nonzero(keys == 0) > 0.15 * keys.size
    assert scratch[0] == 0 and 0 < scratch.sum() < 0.25 * keys.size
    np.testing.assert_array_equal(bins + scratch, np.bincount(keys, minlength=1 << 20))


def test_count_path_rule_at_its_boundary():
    assert bank_count_path(1) == bank_count_path(1024) == bank_count_path(SHARED_ROWS) == "shared"
    assert bank_count_path(SHARED_ROWS + 1) == bank_count_path(1 << 20) == "global"
    # the shared path's bins leave room for three blocks an SM, the global
    # path's table (an int32 key and a uint32 count a slot) for two
    assert 3 * 4 * SHARED_ROWS <= SHARED_BYTES_PER_SM
    assert BLOCKS_PER_SM * 8 * TALLY_SLOTS <= SHARED_BYTES_PER_SM
    # the fleet tick: two blocks an SM; HybridBank's 16384 rows at its
    # chunk: at least a key a bin; the global path, a key a slot
    assert count_split(1 << 25, 1024, 132) == (127_104, BLOCKS_PER_SM * 132)
    assert count_split(909_312, SHARED_ROWS, 132) == (16_536, 55)
    assert count_split(909_312, SHARED_ROWS + 1, 132) == (bank_count.BLOCK_ITEMS, 111)
    assert count_split(1 << 22, SHARED_ROWS, 132) == (16_384, 256)
    for n in (1, 3, 4, 5, bank_count.BLOCK_ITEMS - 1):
        assert count_split(n, 1024, 132) == (-(-n // 4) * 4, 1)


def test_meta_path_returns_empty_limbs_and_declares_its_cost():
    class Collector:
        def __init__(self):
            self.kernels = []

        def on_kernel(self, name, flops, nbytes):
            self.kernels.append((name, flops, nbytes))

        def on_collective(self, kind, nbytes):
            raise AssertionError(kind)

    limbs = torch.empty((1024, 2), dtype=torch.int64, device="meta")
    keys = torch.empty((3, 1 << 10), dtype=torch.int32, device="meta")
    with costs.collecting(Collector()) as seen:
        out = bank_row_count(limbs, keys)
    assert out.device.type == "meta" and out.shape == (1024, 2) and out.dtype == torch.int64
    assert seen.kernels == [("bank_row_count", 0, 4 * 3 * (1 << 10) + 32 * 1024)]
    assert launch_counts()["bank_row_count"] == 0


def test_wrapper_checks_its_inputs():
    limbs = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(TypeError):
        bank_row_count(limbs, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        bank_row_count(limbs[:, :1], torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        bank_row_count(limbs.to(torch.int32), torch.zeros(3, dtype=torch.int32))


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _on_card(limbs, keys):
    """The kernel on the card against its plain version on the card,
    without a read to the host; returns the path's counter name."""
    dev = torch.device("cuda")
    limbs, keys = limbs.to(dev), keys.to(dev)
    before = limbs.clone()
    launches = launch_counts()["bank_row_count"]
    torch.cuda.synchronize()
    obs_metrics.enable()
    obs_metrics.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bank_row_count(limbs, keys)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        seen = {name for name in ("bank.counters.shared", "bank.counters.global")
                if obs_metrics.counter_value(name)}
        obs_metrics.disable()
        obs_metrics.reset()
    want = bank_row_count_plain(limbs, keys)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(limbs, before)
    if keys.numel():
        assert launch_counts()["bank_row_count"] == launches + 1
        assert seen == {f"bank.counters.{bank_count_path(limbs.shape[0])}"}
    return seen


@pytest.mark.gpu
def test_bank_row_count_streams_on_card():
    _need_card()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    # Zipf(1.2) keys of the fleet tick: 2^25 of them over 1024 rows
    weights = torch.arange(1, 1025, dtype=torch.float64, device=dev) ** -1.2
    cdf = torch.cumsum(weights, 0)
    u = torch.rand(1 << 25, generator=gen, dtype=torch.float64, device=dev) * cdf[-1]
    zipf = torch.searchsorted(cdf, u).clamp_(max=1023).to(torch.int32)
    counts = _limbs(np.random.default_rng(1).integers(0, 1 << 40, 1024).tolist())
    _on_card(counts, zipf)
    _on_card(counts, zipf[1:])  # off a 16-byte boundary: the scalar loads
    _on_card(counts, zipf[: (1 << 20) + 3])
    for rows, n in ((1, 7), (5, 1000), (1024, 1 << 22), (SHARED_ROWS, 909_312), (SHARED_ROWS + 1, 909_312),
                    (1 << 20, 1 << 22)):
        for name, (limbs, keys) in _streams(rows, n, rows + n).items():
            _on_card(limbs, torch.from_numpy(keys))
    assert _on_card(counts, zipf[:0]) == set()


@pytest.mark.gpu
def test_banks_count_on_card_like_the_plain_counters():
    _need_card()
    from repro_torch.sketch import HLLConfig, SketchBank
    from repro_torch.sketch.countmin import CMConfig, CountMinBank
    from repro_torch.sketch.sparse import HybridBank

    dev = torch.device("cuda")
    rng = np.random.default_rng(2029)
    for rows, n in ((1024, 1 << 22), (SHARED_ROWS, 909_312)):
        keys = ((rng.zipf(1.2, n) - 1) % rows).astype(np.int32)
        keys[::997] = -1
        keys[1::991] = rows
        items = rng.integers(0, 2**31, n, dtype=np.int32)
        k_t, x_t = torch.from_numpy(keys).to(dev), torch.from_numpy(items).to(dev)
        cfg = HLLConfig(p=12, hash_bits=64)
        banks = {
            "SketchBank": SketchBank.empty(rows, cfg, dev),
            "HybridBank": HybridBank.empty(rows, cfg, device=dev),
            "CountMinBank": CountMinBank.empty(rows, CMConfig(4, 1024), dev),
        }
        for name, bank in banks.items():
            launches = launch_counts()["bank_row_count"]
            once = bank.update_many(k_t, x_t)
            twice = once.update_many(k_t, x_t)
            assert launch_counts()["bank_row_count"] == launches + 2, name
            want = bank_row_count_plain(bank_row_count_plain(bank.n_items, k_t), k_t)
            assert torch.equal(twice.n_items, want), name
            np.testing.assert_array_equal(twice.counts, 2 * np.bincount(keys[(keys >= 0) & (keys < rows)],
                                                                        minlength=rows).astype(np.uint64))
