"""hll_estimate: a uint8 register bank's histogram and its "original" estimates in one launch.

On the CPU the estimators run their plain versions (``register_histogram_plain``,
``_original_device``).  These tests hold the routing (the CPU and other dtypes
plain, uint8 on the card or on ``meta`` the kernel, the mode from the
estimator's name), the ``meta`` path's shapes and declared cost, the launch
plan's limits, and a plain model of the kernel's decomposition (a group of
threads a row, a sub-histogram a warp, their sum, the float64 harmonic sum
over lanes and its butterfly, rounded once, the float32 finalize) to the
plain versions and to the reference's ``register_histogram`` and
``estimate_many`` (JAX), corrupt registers included.

The ``gpu`` tests hold the kernel to its plain version on the card, alone
and through ``SketchBank``, ``HyperLogLog``, ``WindowedBank`` and
``HybridBank``; hold it to the reference, run by JAX on the host, on the
same registers; and check that a read is one launch with no synchronizing
call.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sketch import estimators as ref_est
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch.kernels import hll_estimate as kernel
from repro_torch.kernels import launch_counts
from repro_torch.kernels.hll_estimate import estimate_plan, hll_estimate
from repro_torch.obs import costs
from repro_torch.sketch import HLLConfig, estimators, hll

DEVICE_RTOL = 1e-6  # tests/test_torch_estimators.py's: float32 finalize steps in another order
SHARED_BYTES = 48 * 1024  # dynamic shared memory a block takes without an opt-in


def _rows(cfg: HLLConfig, seed: int) -> np.ndarray:
    """Six (m,) uint8 rows: all zero, saturated, a real stream of 5 m items,
    every register at the rank that puts E past 2^32 / 30 for H = 32, a
    stream with corrupt values (max_rank + 1 .. 255) mixed in, and a few
    registers of 1 (LinearCounting)."""
    rng = np.random.default_rng(seed)
    m, top = cfg.m, cfg.max_rank
    items = torch.from_numpy(rng.integers(0, 2**31, 5 * m, dtype=np.int64).astype(np.int32))
    real = hll.update(hll.init_registers(cfg, "cpu"), items, cfg).numpy()
    large = np.full(m, min(top, 29 - cfg.p), np.uint8)  # E ~ alpha m 2^(29 - p) ~ 0.72 * 2^29 > 2^32 / 30
    corrupt = real.copy()
    hit = rng.random(m) < 0.1
    corrupt[hit] = rng.integers(top + 1, 256, int(hit.sum()))
    sparse = np.zeros(m, np.uint8)
    sparse[rng.integers(0, m, 3)] = 1
    return np.stack([np.zeros(m, np.uint8), np.full(m, top, np.uint8), real, large, corrupt, sparse])


def _bank(cfg: HLLConfig, shape, seed: int = 0, first: int = 0) -> torch.Tensor:
    """A (*shape, m) bank of ``_rows``' rows in turn, from row ``first``."""
    rows = _rows(cfg, seed)
    count = int(np.prod(shape))
    return torch.from_numpy(rows[(first + np.arange(count)) % rows.shape[0]].reshape(tuple(shape) + (cfg.m,)))


def _model(regs: np.ndarray, cfg: HLLConfig):
    """csrc/hll_estimate.cu's arithmetic in numpy for (rows, m) uint8
    registers: (counts (rows, K) int64, "original" estimates (rows,) float32)."""
    rows, m = regs.shape
    k = cfg.max_rank + 1
    group, per_block = estimate_plan(m)
    per_row = group // 32 if group >= 32 else 1
    counts = np.zeros((rows, k), np.int64)
    for r in range(rows):
        # thread g of the row's group loads quads g, g + group, ... and adds
        # each valid value to its warp's sub-histogram; the sums add them
        quads = regs[r].reshape(m // 16, 16).astype(np.int64)
        sub = np.zeros((per_row, k), np.int64)
        for g in range(group):
            vals = quads[g::group].reshape(-1)
            sub[g // 32] += np.bincount(vals[vals < k], minlength=k)
        counts[r] = sub.sum(axis=0)
    # f lanes a row: lane l sums C[k] 2^-k over k = l (mod f) in float64, in
    # order; then the butterfly (lane 0's value) and one rounding to float32
    f = min(32, group)
    lanes = np.zeros((rows, f))
    for kk in range(k):
        lanes[:, kk % f] += counts[:, kk] * 2.0**-kk
    off = f // 2
    while off:
        lanes = lanes + lanes[:, np.arange(f) ^ off]
        off //= 2
    harm = lanes[:, 0].astype(np.float32)
    mf = np.float32(m)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        e_raw = np.float32(hll.alpha(m) * m * m) / harm
        v = counts[:, 0].astype(np.float32)
        lc = mf * np.log(mf / np.maximum(v, np.float32(1)))
        out = np.where((e_raw <= np.float32(2.5) * mf) & (v > 0), lc, e_raw).astype(np.float32)
        if cfg.hash_bits == 32:
            two32 = np.float32(2.0**32)
            large = -two32 * np.log1p(-(e_raw / two32))
            large = np.where(e_raw >= two32, np.float32(np.inf), large)
            out = np.where(e_raw > np.float32(2.0**32 / 30.0), large, out).astype(np.float32)
    return counts, out


def _plain(bank: torch.Tensor, cfg: HLLConfig):
    counts = estimators.register_histogram_plain(bank, cfg)
    return counts, estimators._original_device(counts.to(torch.float32), cfg)


def _weight_gap(counts: np.ndarray) -> np.ndarray:
    """Per row of (..., K) counts: the relative error that the reference's
    float32 weights alone put into its harmonic sum, sum_k C[k] |w[k] -
    2^-k| / sum_k C[k] 2^-k, where w = jnp.exp2(-k) as its _original_device
    computes it.  XLA's exp2 on the host misses 2^-k by up to 2e-6 from k =
    13 (the kernel's weights are exact), so a row with its mass in high
    bins, such as a saturated row at p = 16, H = 64, reads up to 1.3e-6
    off there; a real stream's rows, with their mass below k = 13, ~1e-9."""
    k = counts.shape[-1]
    w = np.array(jnp.exp2(-jnp.arange(k, dtype=jnp.float32)), np.float64)
    exact = 2.0 ** -np.arange(k)
    c = counts.reshape(-1, k).astype(np.float64)
    return (c @ np.abs(w - exact)) / np.maximum(c @ exact, 1e-300)


def _close_to_reference(got, want, counts, what: str) -> None:
    """Estimates within DEVICE_RTOL of the reference's, plus the error of its
    own weights (``_weight_gap``) on each row, with the same infinities."""
    got, want = np.asarray(got, np.float64).reshape(-1), np.asarray(want, np.float64).reshape(-1)
    assert np.array_equal(np.isinf(got), np.isinf(want)), what
    finite = np.isfinite(want)
    gap = np.abs(got[finite] - want[finite]) / np.abs(want[finite]).clip(min=1e-30)
    allowed = DEVICE_RTOL + _weight_gap(np.asarray(counts))[finite]
    assert (gap <= allowed).all(), (what, gap.max(), float(allowed[gap.argmax()]))


def _reference(bank: torch.Tensor, cfg: HLLConfig):
    """The reference's read of the same registers, JAX on the host: (counts
    int32, "original" estimates float32) as CPU tensors."""
    regs, ref_cfg = jnp.asarray(bank.cpu().numpy()), RefConfig(p=cfg.p, hash_bits=cfg.hash_bits)
    counts = np.array(ref_est.register_histogram(regs, ref_cfg))
    return torch.from_numpy(counts), torch.from_numpy(np.array(ref_est.estimate_many(regs, ref_cfg, "original")))


# ----------------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------------


def test_routing_takes_the_kernel_for_uint8_on_the_card_or_meta_only():
    for device in ("cuda", "meta"):
        assert kernel.kernel_takes(torch.device(device), torch.uint8)
        for dtype in (torch.int32, torch.int64, torch.int16):
            assert not kernel.kernel_takes(torch.device(device), dtype)
    assert not kernel.kernel_takes(torch.device("cpu"), torch.uint8)
    # the kernel finalizes "original"; the other estimators take its counts
    assert kernel.FINALIZED == ("original",) and set(kernel.FINALIZED) <= set(estimators.available_estimators())
    assert kernel.MODES == ("histogram", "original")


@pytest.mark.parametrize("estimator", ["original", "ertl_improved", "ertl_mle"])
def test_cpu_banks_take_the_plain_versions(estimator):
    cfg = HLLConfig(p=8, hash_bits=64)
    bank = _bank(cfg, (2, 3))
    before = launch_counts()["hll_estimate"]
    with costs.collecting(_Collector()) as seen:
        counts = estimators.register_histogram(bank, cfg)
        got = estimators.estimate_many(bank, cfg, estimator)
    assert seen.kernels == [] and launch_counts()["hll_estimate"] == before
    want_counts, _ = _plain(bank, cfg)
    assert torch.equal(counts, want_counts)
    want = estimators.get_estimator(estimator).device(want_counts.to(torch.float32), cfg)
    assert torch.equal(got, want)
    # the routing is the estimators' (kernel_takes): the wrapper itself takes no CPU bank
    for mode in kernel.MODES:
        with pytest.raises(ValueError, match="CUDA"):
            hll_estimate(bank, cfg, mode)


class _Collector:
    def __init__(self):
        self.kernels = []

    def on_kernel(self, name, flops, nbytes):
        self.kernels.append((name, flops, nbytes))

    def on_collective(self, kind, nbytes):
        raise AssertionError(kind)


@pytest.mark.parametrize("shape", [(), (3,), (2, 3)])
def test_meta_path_gives_the_kernel_shapes_and_declares_its_cost(shape):
    cfg = HLLConfig(p=12, hash_bits=64)
    k, rows = cfg.max_rank + 1, int(np.prod(shape))
    bank = torch.empty(shape + (cfg.m,), dtype=torch.uint8, device="meta")
    with costs.collecting(_Collector()) as seen:
        counts = estimators.register_histogram(bank, cfg)
        est = estimators.estimate_many(bank, cfg, "original")
        other = estimators.estimate_many(bank, cfg, "ertl_improved")
    assert counts.device.type == "meta" and counts.shape == shape + (k,) and counts.dtype == torch.int32
    assert est.device.type == "meta" and est.shape == shape and est.dtype == torch.float32
    assert other.shape == shape
    hist_cost, est_cost = kernel._cost(rows, cfg, "histogram"), kernel._cost(rows, cfg, "original")
    assert hist_cost == (0, rows * cfg.m + 4 * rows * k) and est_cost == (2 * k * rows, rows * cfg.m + 4 * rows)
    # the ertl read histograms through the kernel, then finalizes in plain ops
    assert seen.kernels == [("hll_estimate", *hist_cost), ("hll_estimate", *est_cost), ("hll_estimate", *hist_cost)]
    assert launch_counts()["hll_estimate"] == 0
    # another register dtype on meta keeps the plain path: no kernel cost
    with costs.collecting(_Collector()) as seen:
        wide = estimators.estimate_many(bank.to(torch.int32), cfg, "original")
    assert seen.kernels == [] and wide.shape == shape


@pytest.mark.parametrize("p", range(4, 17))
def test_estimate_plan_fits_the_kernel_limits(p):
    m = 1 << p
    group, rows = estimate_plan(m)
    threads = group * rows
    assert group & (group - 1) == 0 and (m // 16) % group == 0
    assert threads % 32 == 0 and threads <= kernel.ROW_THREADS and 1 <= rows <= kernel.BLOCK_ROWS
    assert group >= 32 or 32 % group == 0  # a row's threads are whole warps or an aligned segment of one
    for h in (32, 64):
        bins = h - p + 2  # a sub-histogram for each warp of a row, or one for a row of fewer threads
        assert bins <= 62 and 4 * rows * max(1, group // 32) * bins <= SHARED_BYTES


def test_estimate_plan_at_the_callers_shapes():
    assert estimate_plan(1 << 12) == (256, 1)  # the fleet bank: a block a row
    assert estimate_plan(1 << 16) == (512, 1)  # one wide block for a p = 16 sketch
    assert estimate_plan(1 << 14) == (512, 1)
    assert estimate_plan(16) == (1, 32)
    assert estimate_plan(1 << 9) == (32, 8)


@pytest.mark.parametrize("shape", [(3,), (2, 3)])
@pytest.mark.parametrize("hash_bits", [32, 64])
@pytest.mark.parametrize("p", [4, 12, 16])
def test_kernel_decomposition_matches_plain(p, hash_bits, shape):
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    # (3,): the large-range, corrupt and LinearCounting rows; (2, 3): all six
    bank = _bank(cfg, shape, seed=p * hash_bits, first=3 if shape == (3,) else 0)
    counts, est = _model(bank.reshape(-1, cfg.m).numpy(), cfg)
    want_counts, want = _plain(bank, cfg)
    np.testing.assert_array_equal(counts.reshape(want_counts.shape), want_counts.numpy())
    want = want.numpy().reshape(-1)
    assert np.array_equal(np.isinf(est), np.isinf(want))
    np.testing.assert_allclose(est, want, rtol=DEVICE_RTOL)
    if hash_bits == 32 and shape == (2, 3):
        assert np.isinf(est).any() and (np.isfinite(est) & (est > 2.0**32 / 30)).any()


@pytest.mark.parametrize("hash_bits", [32, 64])
@pytest.mark.parametrize("p", [4, 12, 16])
def test_kernel_decomposition_matches_the_reference(p, hash_bits):
    """The model's counts equal the reference's bincount, and its estimates,
    from the float64 harmonic sum rounded once, land within DEVICE_RTOL of
    the reference's float32 ``counts @ w`` (plus its weights' own error),
    with the same infinities, on all six rows."""
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    bank = _bank(cfg, (2, 3), seed=p * hash_bits)
    counts, est = _model(bank.reshape(-1, cfg.m).numpy(), cfg)
    want_counts, want = _reference(bank, cfg)
    np.testing.assert_array_equal(counts.reshape(want_counts.shape), want_counts.numpy())
    _close_to_reference(est, want, counts, f"p={p} H={hash_bits}")
    if (p, hash_bits) == (16, 64):  # the saturated row: the reference's weight 2^-49 is 1.3e-6 off
        assert _weight_gap(counts)[1] > DEVICE_RTOL


def test_corrupt_registers_count_nowhere_and_never_in_the_next_row():
    cfg = HLLConfig(p=4, hash_bits=64)
    bank = torch.zeros((3, cfg.m), dtype=torch.uint8)
    bank[0] = torch.tensor([cfg.max_rank + 1, 255, 200, 63, 62, 61, 0, 1] * 2, dtype=torch.uint8)
    bank[1, :4] = 5
    counts, _ = _model(bank.numpy(), cfg)
    for got in (counts, estimators.register_histogram(bank, cfg).numpy(),
                _reference(bank, cfg)[0].numpy()):
        assert got[0].sum() == 6  # 61, 0 and 1 twice; 62, 63, 200 and 255 dropped
        assert got[0, cfg.max_rank] == 2 and got[0, 0] == 2 and got[0, 1] == 2
        np.testing.assert_array_equal(got[1], np.bincount([5] * 4 + [0] * 12, minlength=cfg.max_rank + 1))
        np.testing.assert_array_equal(got[2], np.eye(cfg.max_rank + 1, dtype=np.int64)[0] * cfg.m)


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    got, want = got.cpu().double(), want.cpu().double()
    assert got.shape == want.shape, what
    assert torch.equal(torch.isinf(got), torch.isinf(want)), what
    finite = torch.isfinite(want)
    torch.testing.assert_close(got[finite], want[finite], rtol=DEVICE_RTOL, atol=0, msg=what)


def _against_plain(bank: torch.Tensor, cfg: HLLConfig, what: str) -> None:
    """The kernel on the card against its plain version on the card: the
    counts bit for bit, the estimates within DEVICE_RTOL; one launch each."""
    launches = launch_counts()["hll_estimate"]
    counts = hll_estimate(bank, cfg, "histogram")
    est = hll_estimate(bank, cfg, "original")
    assert launch_counts()["hll_estimate"] == launches + 2, what
    want_counts, want = _plain(bank, cfg)
    assert counts.dtype == torch.int32 and torch.equal(counts, want_counts), what
    _close(est, want, what)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    _need_card()
    dev = torch.device("cuda")
    for p in (4, 8, 12, 16):
        for hash_bits in (32, 64):
            cfg = HLLConfig(p=p, hash_bits=hash_bits)
            for shape in ((), (1,), (3,), (2, 3), (1000,)):
                bank = _bank(cfg, shape, seed=p + hash_bits).to(dev)
                _against_plain(bank, cfg, f"p={p} H={hash_bits} shape={shape}")
            # registers off a 16-byte boundary: the wrapper's aligned copy
            flat = _bank(cfg, (4,)).reshape(-1).to(dev)
            _against_plain(flat[1: 1 + 3 * cfg.m].view(3, cfg.m), cfg, f"p={p} H={hash_bits} offset 1")


def _fleet_bank(dev: torch.device, cfg: HLLConfig):
    """The fleet's (1024, m) SketchBank after one tick: 2^25 Zipf(1.2) keys
    over its 1024 rows, uniform items."""
    from repro_torch.sketch import SketchBank

    gen = torch.Generator(device=dev).manual_seed(34)
    weights = torch.arange(1, 1025, dtype=torch.float64, device=dev) ** -1.2
    cdf = torch.cumsum(weights, 0)
    u = torch.rand(1 << 25, generator=gen, dtype=torch.float64, device=dev) * cdf[-1]
    keys = torch.searchsorted(cdf, u).clamp_(max=1023).to(torch.int32)
    items = torch.randint(0, 2**31 - 1, (1 << 25,), generator=gen, dtype=torch.int32, device=dev)
    return SketchBank.empty(1024, cfg, dev).update_many(keys, items)


@pytest.mark.gpu
def test_fleet_bank_after_a_zipf_tick_on_card():
    _need_card()
    cfg = HLLConfig(p=12, hash_bits=64)
    bank = _fleet_bank(torch.device("cuda"), cfg)
    _against_plain(bank.registers, cfg, "fleet bank")
    _close(bank.estimate_many(), _plain(bank.registers.cpu(), cfg)[1], "fleet bank against the CPU's plain read")


REFERENCE_CASES = ["fleet bank after a Zipf(1.2) tick"] + [f"special rows p={p} H={h}" for p in (4, 12, 16)
                                                           for h in (32, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_kernel_on_card_matches_the_reference(case):
    """The card's read (``register_histogram`` and ``estimate_many``
    "original", one launch each) against the reference's, JAX on the host,
    on the same registers: the counts bit for bit, the estimates within
    DEVICE_RTOL (plus the error of the reference's own weights,
    ``_weight_gap``) with the same infinities."""
    _need_card()
    dev = torch.device("cuda")
    if case.startswith("fleet"):
        cfg = HLLConfig(p=12, hash_bits=64)
        bank = _fleet_bank(dev, cfg).registers
    else:
        p, h = (int(part.split("=")[1]) for part in case.split()[-2:])
        cfg = HLLConfig(p=p, hash_bits=h)
        # all six of _rows' rows, twice over: zero, saturated (+inf at H = 32),
        # a real stream, large range, corrupt values, LinearCounting
        bank = _bank(cfg, (2, 6), seed=p * h).to(dev)
    launches = launch_counts()["hll_estimate"]
    counts = estimators.register_histogram(bank, cfg)
    est = estimators.estimate_many(bank, cfg, "original")
    assert launch_counts()["hll_estimate"] == launches + 2, case
    want_counts, want = _reference(bank, cfg)
    assert counts.dtype == torch.int32 and torch.equal(counts.cpu(), want_counts), case
    _close_to_reference(est.cpu().numpy(), want.numpy(), want_counts.numpy(), case)
    if cfg.hash_bits == 32 and not case.startswith("fleet"):
        assert torch.isinf(est).any(), case


@pytest.mark.gpu
def test_carriers_read_through_the_kernel_on_card():
    _need_card()
    from repro_torch.sketch import HybridBank, HyperLogLog, SketchBank, WindowedBank

    dev = torch.device("cuda")
    rng = np.random.default_rng(34)
    for p, hash_bits in ((12, 64), (16, 32), (4, 32)):
        cfg = HLLConfig(p=p, hash_bits=hash_bits)
        keys = torch.from_numpy(((rng.zipf(1.2, 1 << 20) - 1) % 64).astype(np.int32)).to(dev)
        items = torch.from_numpy(rng.integers(0, 2**31, 1 << 20, dtype=np.int32)).to(dev)

        def plain(regs):
            return _plain(regs.cpu(), cfg)[1]

        what = f"p={p} H={hash_bits}"
        before = launch_counts()["hll_estimate"]
        sk = HyperLogLog.empty(cfg, dev).update(items)
        _close(sk.estimate_device(), plain(sk.registers), f"HyperLogLog {what}")
        assert torch.equal(sk.histogram(), estimators.register_histogram_plain(sk.registers, cfg))
        bank = SketchBank.empty(64, cfg, dev).update_many(keys, items)
        _close(bank.estimate_many(), plain(bank.registers), f"SketchBank {what}")
        ring = WindowedBank.empty(4, 64, cfg, dev)
        for epoch in range(3):
            ring = ring.advance_to(epoch).observe(keys[epoch::3], items[epoch::3])
        _close(ring.estimate_window(), plain(ring.fold_window().registers), f"WindowedBank {what}")
        hybrid = HybridBank.empty(64, cfg, device=dev).update_many(keys, items)
        dense = hybrid.to_dense()
        est = hybrid.estimate_many()
        _close(est, plain(dense.registers), f"HybridBank {what}")
        sparse_rows = hybrid.dense_slot < 0
        # a sparse row's LinearCounting read equals the kernel's, bit for bit
        assert torch.equal(est[sparse_rows], dense.estimate_many()[sparse_rows]), what
        # at least the sketch's two reads, the bank's and the window's
        assert launch_counts()["hll_estimate"] >= before + 4, what


@pytest.mark.gpu
def test_a_read_is_one_launch_and_no_sync_on_card():
    _need_card()
    from repro_torch.sketch import HyperLogLog, SketchBank

    dev = torch.device("cuda")
    cfg = HLLConfig(p=12, hash_bits=64)
    keys = torch.arange(1 << 20, dtype=torch.int32, device=dev) % 1024
    bank = SketchBank.empty(1024, cfg, dev).update_many(keys, keys * 7919)
    sketch = HyperLogLog.empty(HLLConfig(p=16, hash_bits=64), dev).update(
        torch.arange(1 << 18, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    for read in (bank.estimate_many, sketch.estimate_device):
        launches = launch_counts()["hll_estimate"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            est = read()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert launch_counts()["hll_estimate"] == launches + 1
        assert torch.isfinite(est).all()
