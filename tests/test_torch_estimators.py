"""Port vs reference: the register histogram and the three estimators.

* The exact host paths (float64 / python ints) run the same arithmetic in
  both packages, so they must be EQUAL, including the golden pins of
  tests/test_estimators.py.
* The float32 device paths compute the same formulas, but the two
  frameworks call different float32 log/expm1 implementations, each good
  to an ulp or two (the reference's own eager and jitted paths already
  differ by 1 ulp).  So the port's ``estimate_many`` is held to the
  reference's within rtol 1e-6 (about 8 float32 ulps), with two stated
  exceptions, both limits of the reference's own float32 arithmetic
  (ROADMAP.md §C):
  - a saturated sketch, whose harmonic sum is all 2^-max_rank: XLA's CPU
    exp2 is inexact below 2^-12 (up to 2e-6 relative), so there the port,
    whose weights are exact powers of two, is held to the exact float64
    host path within rtol 1e-6 instead;
  - ertl_mle bisects on float32 values of log2(lambda/m), so its result
    lands on that grid, and where n/m is far from 1 float32 rounding of
    the log-likelihood slope makes the last bisection steps ambiguous, so
    each package may stop up to two grid steps from the exact root.  Where
    |log2(n/m)| >= 8 one step is already ln2 * 2^-20 ~ 6.6e-7, and the
    bound there is four grid steps.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.sketch import estimators as ref_est
from repro.sketch import hll as ref_hll
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch.sketch import estimators as est
from repro_torch.sketch import hll
from repro_torch.sketch.hll import HLLConfig

ESTIMATORS = ("original", "ertl_improved", "ertl_mle")
DEVICE_RTOL = 1e-6  # see the module docstring

# (p, H, n, rng seed, estimate): the golden pins of tests/test_estimators.py
GOLDEN = [
    (10, 64, 100, 0, 105.2259675727554),
    (10, 64, 5000, 1, 5267.28249218302),
    (12, 64, 200000, 2, 197827.12799793802),
    (14, 32, 3000, 3, 3000.7620341689494),
    (14, 32, 2000000, 4, 2019074.3597214979),
    (16, 64, 1000000, 5, 996494.3822282938),
    (8, 32, 50, 6, 50.70589792309603),
    (14, 64, 50000, 7, 50449.459385639755),
]


def _items(n, seed):
    return np.random.default_rng(seed).integers(0, 2**31, n, dtype=np.int32)


def _regs(cfg, n, seed):
    return hll.update(hll.init_registers(cfg, "cpu"), torch.from_numpy(_items(n, seed)), cfg)


def _bank(p, hash_bits, sizes):
    """A stack of sketches spanning the LC, transition and raw ranges."""
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    regs = [_regs(cfg, n, i) for i, n in enumerate(sizes)]
    regs.append(torch.zeros(cfg.m, dtype=torch.uint8))  # empty sketch
    regs.append(torch.full((cfg.m,), cfg.max_rank, dtype=torch.uint8))  # saturated
    return cfg, torch.stack(regs)


@pytest.mark.parametrize("p,H,n,seed,expected", GOLDEN)
def test_original_golden_pins(p, H, n, seed, expected):
    cfg = HLLConfig(p=p, hash_bits=H)
    regs = _regs(cfg, n, seed)
    assert hll.estimate(regs, cfg) == expected
    assert est.estimate(regs, cfg, "original") == expected


def test_original_large_range_golden():
    regs = torch.full((1 << 14,), 18, dtype=torch.uint8)
    assert hll.estimate(regs, HLLConfig(p=14, hash_bits=32)) == 5486601362.617552


@pytest.mark.parametrize("hash_bits", [32, 64])
@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_host_estimates_equal_reference(p, hash_bits):
    cfg, bank = _bank(p, hash_bits, (1, 10, 3 << p, 7 << p, 40 << p))
    rcfg = RefConfig(p=p, hash_bits=hash_bits)
    for regs in bank:
        for name in ESTIMATORS:
            want = ref_est.estimate(np.asarray(regs.numpy()), rcfg, name)
            assert est.estimate(regs, cfg, name) == want
        counts = est.register_histogram_host(regs, cfg)
        np.testing.assert_array_equal(counts, ref_est.register_histogram_host(regs.numpy(), rcfg))


def _mle_rtol(estimates, m):
    """The ertl_mle bound: 1e-6, or four float32 steps of log2(lambda/m)
    where |log2(lambda/m)| >= 8."""
    with np.errstate(divide="ignore", invalid="ignore"):
        log2x = np.abs(np.log2(np.asarray(estimates, np.float64) / m)).astype(np.float32)
        grid = np.log(2.0) * np.spacing(log2x).astype(np.float64)
    # 0 and inf (empty, saturated) are exact in both: no grid there
    return np.where(np.isfinite(grid) & (log2x >= 8), 4 * grid, DEVICE_RTOL)


@pytest.mark.parametrize("hash_bits", [32, 64])
@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_estimate_many_within_stated_bound_of_reference(p, hash_bits):
    cfg, bank = _bank(p, hash_bits, (1, 10, 3 << p, 7 << p, 40 << p))
    rcfg = RefConfig(p=p, hash_bits=hash_bits)
    live = slice(0, bank.shape[0] - 1)  # every row but the saturated one
    for name in ESTIMATORS:
        got = est.estimate_many(bank, cfg, name)
        assert got.dtype == torch.float32 and got.shape == (bank.shape[0],)
        got = got.numpy().astype(np.float64)
        want = np.asarray(ref_est.estimate_many(jnp.asarray(bank.numpy()), rcfg, name))
        want = want.astype(np.float64)[live]
        rtol = _mle_rtol(want, cfg.m) if name == "ertl_mle" else DEVICE_RTOL
        with np.errstate(invalid="ignore"):  # the empty row is 0 in both
            err = np.where(got[live] == want, 0.0, np.abs(got[live] - want) / np.abs(want))
        assert (err <= rtol).all(), (name, err, rtol)
        saturated = est.estimate(bank[-1], cfg, name)
        np.testing.assert_allclose(got[-1], saturated, rtol=DEVICE_RTOL)
        # one sketch at a time agrees with the batch (the histogram dot
        # product may sum in another order: the reference allows 1e-6 too)
        one = est.estimate_device(bank[2], cfg, name)
        np.testing.assert_allclose(float(one), got[2], rtol=DEVICE_RTOL)


def test_device_weights_are_exact_powers_of_two():
    counts = torch.zeros(3)
    w = est._pow2_weights(0, 62, counts).numpy()
    np.testing.assert_array_equal(w, np.ldexp(np.float32(1), -np.arange(62)))


def test_histogram_device_matches_host_and_reference():
    cfg, bank = _bank(10, 64, (100, 20_000))
    hs = est.register_histogram(bank, cfg)
    assert hs.dtype == torch.int32 and hs.shape == (bank.shape[0], est.histogram_size(cfg))
    for i in range(bank.shape[0]):
        np.testing.assert_array_equal(hs[i].numpy(), est.register_histogram_host(bank[i], cfg))
    ref = ref_est.register_histogram(jnp.asarray(bank.numpy()), RefConfig(p=10))
    np.testing.assert_array_equal(hs.numpy(), np.asarray(ref))


def test_histogram_drops_corrupt_registers_without_leaking():
    cfg = HLLConfig(p=4, hash_bits=32)
    bank = torch.zeros((3, cfg.m), dtype=torch.uint8)
    bank[1, 0] = 200  # beyond max_rank: only possible from a corrupt blob
    hs = est.register_histogram(bank, cfg)
    ref = ref_est.register_histogram(jnp.asarray(bank.numpy()), RefConfig(p=4, hash_bits=32))
    np.testing.assert_array_equal(hs.numpy(), np.asarray(ref))
    assert int(hs[0].sum()) == int(hs[2].sum()) == cfg.m and int(hs[1].sum()) == cfg.m - 1
    with pytest.raises(ValueError, match="exceeds max_rank"):
        est.estimate(bank[1], cfg)


def test_estimate_from_histogram_matches_reference_and_validates():
    cfg = HLLConfig(p=10, hash_bits=64)
    regs = _regs(cfg, 30_000, 4)
    counts = est.register_histogram_host(regs, cfg)
    for name in ESTIMATORS:
        assert est.estimate_from_histogram(counts, cfg, name) == ref_est.estimate_from_histogram(
            counts, RefConfig(p=10), name
        )
    with pytest.raises(ValueError, match="histogram"):
        est.estimate_from_histogram(np.zeros(5, np.int64), cfg)
    with pytest.raises(ValueError, match="sums to"):
        est.estimate_from_histogram(np.zeros(est.histogram_size(cfg), np.int64), cfg)


def test_validation_and_registry_match_reference():
    cfg = HLLConfig(p=8)
    with pytest.raises(ValueError, match="registers"):
        est.estimate(torch.zeros(10, dtype=torch.uint8), cfg)
    with pytest.raises(ValueError, match="integer"):
        est.estimate_device(torch.zeros(cfg.m), cfg)
    with pytest.raises(ValueError, match="unknown estimator"):
        est.estimate(torch.zeros(cfg.m, dtype=torch.uint8), cfg, "nope")
    assert est.available_estimators() == ref_est.available_estimators()
    assert est.DEFAULT_ESTIMATOR == ref_est.DEFAULT_ESTIMATOR
    assert hll.alpha(16) == ref_hll.alpha(16) and hll.alpha(1 << 16) == ref_hll.alpha(1 << 16)
    for x in (0.0, 0.3, 0.999, 1.0):
        assert est._sigma(x) == ref_est._sigma(x) or (math.isinf(est._sigma(x)) and x >= 1.0)
        assert est._tau(x) == ref_est._tau(x)
