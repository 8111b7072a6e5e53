"""Pluggable cardinality estimators over the register histogram (phase 4).

Port of ``repro/sketch/estimators.py``.  Every estimator consumes the
register histogram C[k] = |{j : M[j] = k}| (length max_rank + 1), and ships
two finalizers:

  host    (np int histogram, cfg) -> python float; exact float64/bignum
          arithmetic -- the authoritative path, the reference's code as is.
  device  ((..., K) float32 histogram batch, cfg) -> (...,) float32 on the
          histogram's device; fixed-iteration and batch-vectorized -- the
          engine behind :func:`estimate_many`, which finalizes a stacked
          (B, m) register bank in one pass instead of B python iterations.

Registered: ``original`` (Flajolet + the paper's empirical corrections),
``ertl_improved`` (arXiv:1702.01284 Alg. 6) and ``ertl_mle`` (Poisson
maximum likelihood by bisection).  See DESIGN.md §8.

A uint8 bank on the card is read by one launch of the ``hll_estimate``
kernel (``repro_torch.kernels.hll_estimate``; the reference leaves the
histogram to XLA's ``bincount``), with no read to the host: it writes the
"original" estimates itself, and the counts that every other estimator's
device finalizer takes.  CPU tensors, and other register dtypes, keep the
plain ``register_histogram_plain`` (one ``torch.bincount``) and
``_original_device``, which the kernel's tests hold it to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import hll_estimate as _kernel
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing
from repro_torch.sketch.hll import HLLConfig, alpha

# alpha_infinity = 1 / (2 ln 2): the bias constant of Ertl's raw estimator.
ALPHA_INF = 1.0 / (2.0 * math.log(2.0))


# ----------------------------------------------------------------------------
# register validation + the histogram intermediate
# ----------------------------------------------------------------------------


def _is_integer_dtype(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)
    return np.issubdtype(dtype, np.integer)


def validate_registers(registers, cfg: HLLConfig, batched: bool = False):
    """Raise ValueError unless ``registers`` is an integer (m,) array.

    With ``batched=True`` any (..., m) stack is accepted.  Takes a tensor or
    a numpy array.
    """
    shape = tuple(registers.shape)
    if batched:
        if len(shape) < 1 or shape[-1] != cfg.m:
            raise ValueError(
                f"expected a (..., {cfg.m}) register bank, got {shape}"
            )
    elif shape != (cfg.m,):
        raise ValueError(f"expected {(cfg.m,)} registers, got {shape}")
    if not _is_integer_dtype(registers.dtype):
        raise ValueError(f"registers must be an integer array, got {registers.dtype}")


def histogram_size(cfg: HLLConfig) -> int:
    """K = max_rank + 1 bins: register values live in [0, H - p + 1]."""
    return cfg.max_rank + 1


def register_histogram(registers: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    """Device histogram: (..., m) registers -> (..., K) int32 counts.

    A uint8 bank on the card (or on ``meta``) takes the ``hll_estimate``
    kernel, every other bank :func:`register_histogram_plain`.  A register
    value beyond max_rank (possible only via a corrupted blob) counts
    nowhere, never in a neighboring batch; the host path raises on the
    same input.
    """
    validate_registers(registers, cfg, batched=True)
    if _kernel.kernel_takes(registers.device, registers.dtype):
        return _kernel.hll_estimate(registers, cfg, "histogram")
    return register_histogram_plain(registers, cfg)


def register_histogram_plain(registers: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    """The plain histogram: one bincount for the whole (possibly batched)
    bank, batch b's registers offset by b*K.  A register value beyond
    max_rank is routed to a trailing bin that is dropped.  On ``meta``
    tensors (the dry-run's training step), where bincount has no kernel
    (its output length depends on the data), the counts are an empty
    tensor of their shape.
    """
    validate_registers(registers, cfg, batched=True)
    k = histogram_size(cfg)
    batch_shape = tuple(registers.shape[:-1])
    b = math.prod(batch_shape)
    flat = registers.reshape(b, cfg.m).to(torch.int64)
    idx = flat + k * torch.arange(b, dtype=torch.int64, device=flat.device)[:, None]
    # invalid (negative or > max_rank) -> dropped, never leaked to a neighbor
    idx = torch.where((flat >= 0) & (flat < k), idx, b * k)
    if idx.device.type == "meta":
        counts = torch.empty(b * k, dtype=torch.int64, device=idx.device)
    else:
        counts = torch.bincount(idx.reshape(-1), minlength=b * k + 1)[: b * k]
    return counts.reshape(batch_shape + (k,)).to(torch.int32)


def _to_numpy(registers) -> np.ndarray:
    if isinstance(registers, torch.Tensor):
        return registers.detach().cpu().numpy()
    return np.asarray(registers)


def register_histogram_host(registers, cfg: HLLConfig) -> np.ndarray:
    """Host histogram (exact int64 counts) with full validation."""
    regs = _to_numpy(registers)
    validate_registers(regs, cfg, batched=False)
    counts = np.bincount(regs.astype(np.int64), minlength=histogram_size(cfg))
    if counts.shape[0] != histogram_size(cfg):
        raise ValueError(
            f"register value {regs.max()} exceeds max_rank {cfg.max_rank}"
        )
    return counts


# ----------------------------------------------------------------------------
# the estimator registry
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Estimator:
    """A named finalization strategy over the register histogram."""

    name: str
    host: Callable  # (np int histogram (K,), cfg) -> float, exact
    device: Callable  # ((..., K) f32 histogram, cfg) -> (...,) f32
    doc: str = ""


_ESTIMATORS: Dict[str, Estimator] = {}

DEFAULT_ESTIMATOR = "original"


def register_estimator(
    name: str, host: Callable, device: Callable, doc: str = ""
) -> Estimator:
    """Register an estimator under ``name``."""
    if name in _ESTIMATORS:
        raise ValueError(f"estimator {name!r} already registered")
    est = Estimator(name=name, host=host, device=device, doc=doc)
    _ESTIMATORS[name] = est
    return est


def get_estimator(name: str) -> Estimator:
    try:
        return _ESTIMATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown estimator {name!r}; registered: {sorted(_ESTIMATORS)}"
        ) from None


def available_estimators() -> Tuple[str, ...]:
    return tuple(sorted(_ESTIMATORS))


def _pow2_weights(lo: int, hi: int, like: torch.Tensor) -> torch.Tensor:
    """float32 2^-k for k in [lo, hi) on ``like``'s device (exact values)."""
    k = torch.arange(lo, hi, dtype=torch.float32, device=like.device)
    return torch.exp2(-k)


def _over(numerator: float, denominator: torch.Tensor) -> torch.Tensor:
    """float32(numerator) / denominator, rounded once.

    A python number over a tensor is ``reciprocal(t) * number`` in
    PyTorch, which rounds twice; JAX rounds the number to float32 and
    divides, and this matches it.
    """
    return torch.tensor(numerator, dtype=denominator.dtype, device=denominator.device) / denominator


# ----------------------------------------------------------------------------
# "original": Flajolet + empirical-threshold corrections (paper Algorithm 1)
# ----------------------------------------------------------------------------


def _linear_counting(m: int, v: int) -> float:
    """LinearCounting(m, V) = m * ln(m / V)   (Algorithm 1 line 25)."""
    return m * math.log(m / v)


def _original_host(counts: np.ndarray, cfg: HLLConfig) -> float:
    """Exact host finalizer: the harmonic sum as one python integer.

    S = sum_k C[k] 2^(max_rank - k) is exact, so the raw estimate
    E = alpha * m^2 * 2^max_rank / S is exact up to one final division.
    """
    m = cfg.m
    s = 0
    for k, c in enumerate(counts):
        if c:
            s += int(c) << int(cfg.max_rank - k)
    e_raw = alpha(m) * m * m * (1 << cfg.max_rank) / s

    v = int(counts[0])
    if e_raw <= 2.5 * m:
        if v != 0:
            return _linear_counting(m, v)  # small range correction
        return e_raw
    if cfg.hash_bits == 32:
        two32 = float(1 << 32)
        if e_raw <= two32 / 30.0:
            return e_raw
        if e_raw >= two32:
            # a 32-bit hash cannot distinguish beyond its own range
            return math.inf
        return -two32 * math.log(1.0 - e_raw / two32)  # large range correction
    # 64-bit hash: large-range correction obsolete (paper §V-A.7)
    return e_raw


def _original_device(counts: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    m = float(cfg.m)
    harm = counts @ _pow2_weights(0, histogram_size(cfg), counts)
    e_raw = _over(alpha(cfg.m) * m * m, harm)
    v = counts[..., 0]
    lc = m * torch.log(_over(m, torch.clamp(v, min=1.0)))
    out = torch.where((e_raw <= 2.5 * m) & (v > 0), lc, e_raw)
    if cfg.hash_bits == 32:
        two32 = float(1 << 32)
        large = -two32 * torch.log1p(-(e_raw / two32))
        large = torch.where(e_raw >= two32, torch.inf, large)  # saturated, not NaN
        out = torch.where(e_raw > two32 / 30.0, large, out)
    return out


# ----------------------------------------------------------------------------
# "ertl_improved": sigma/tau-corrected raw estimator (1702.01284 Alg. 6)
# ----------------------------------------------------------------------------


def _sigma(x: float) -> float:
    """sigma(x) = x + sum_{k>=1} x^(2^k) 2^(k-1); the C[0] tail correction."""
    if x >= 1.0:
        return math.inf
    y, z = 1.0, x
    while True:
        x *= x
        z_prev = z
        z += x * y
        y += y
        if z == z_prev or x == 0.0:
            return z


def _tau(x: float) -> float:
    """tau(x) = (1/3)(1 - x - sum_{k>=1}(1 - x^(2^-k))^2 2^-k); C[q+1] tail."""
    if x <= 0.0 or x >= 1.0:
        return 0.0
    y, z = 1.0, 1.0 - x
    while True:
        x = math.sqrt(x)
        z_prev = z
        y *= 0.5
        z -= (1.0 - x) ** 2 * y
        if z == z_prev:
            return z / 3.0


def _ertl_z(counts, cfg: HLLConfig, sigma_fn, tau_fn):
    """The corrected harmonic denominator z shared by improved + MLE seed.

    z = m tau(1 - C[q+1]/m) 2^-q + sum_{k=1..q} C[k] 2^-k + m sigma(C[0]/m)
    evaluated with Ertl's halving recurrence (deepest registers first).
    """
    m = cfg.m
    q = cfg.max_rank - 1  # = H - p
    z = m * tau_fn(1.0 - counts[q + 1] / m)
    for k in range(q, 0, -1):
        z = 0.5 * (z + float(counts[k]))
    return z + m * sigma_fn(counts[0] / m)


def _ertl_improved_host(counts: np.ndarray, cfg: HLLConfig) -> float:
    z = _ertl_z(counts, cfg, _sigma, _tau)
    if math.isinf(z):
        return 0.0  # every register zero: the sketch has seen nothing
    if z == 0.0:
        return math.inf  # every register saturated
    return ALPHA_INF * cfg.m * cfg.m / z


def _sigma_device(x: torch.Tensor, iters: int = 32) -> torch.Tensor:
    xx, y, z = x, torch.ones_like(x), x
    for _ in range(iters):
        xx = xx * xx
        z = z + xx * y
        y = y + y
    # x^(2^i) underflows to 0 well inside `iters` for any float32 x < 1;
    # x == 1 diverges and is patched to the analytic limit here.
    return torch.where(x >= 1.0, torch.inf, z)


def _tau_device(x: torch.Tensor, iters: int = 32) -> torch.Tensor:
    xx, y, z = x, torch.ones_like(x), 1.0 - x
    for _ in range(iters):
        xx = torch.sqrt(xx)
        y = 0.5 * y
        z = z - torch.square(1.0 - xx) * y
    return torch.where((x <= 0.0) | (x >= 1.0), 0.0, z / 3.0)


def _ertl_improved_device(counts: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    m = float(cfg.m)
    q = cfg.max_rank - 1
    # closed form of the halving recurrence: z = z_tau 2^-q + sum C[k] 2^-k
    z = (
        m * _tau_device(1.0 - counts[..., q + 1] / m) * (2.0**-q)
        + counts[..., 1 : q + 1] @ _pow2_weights(1, q + 1, counts)
        + m * _sigma_device(counts[..., 0] / m)
    )
    # z = +inf (all-zero sketch) -> 0; z = 0 (saturated) -> +inf: both are
    # the correct limits and fall out of the float division for free.
    return _over(ALPHA_INF * m * m, z)


# ----------------------------------------------------------------------------
# "ertl_mle": Poisson maximum-likelihood over the histogram
# ----------------------------------------------------------------------------
#
# With per-register rate x = lambda / m the log-likelihood derivative is
#   f(x) = -C[0] + sum_{k=1..q} C[k] 2^-k (1/expm1(x 2^-k) - 1)
#               + C[q+1] 2^-q / expm1(x 2^-q)
# strictly decreasing, so bisection converges to its unique positive root.


def _mle_dlogl_host(x: float, counts: np.ndarray, q: int) -> float:
    s = -float(counts[0])
    for k in range(1, q + 1):
        c = counts[k]
        if c:
            u = x * 2.0**-k
            s += float(c) * 2.0**-k * (1.0 / float(np.expm1(u)) - 1.0)
    if counts[q + 1]:
        u = x * 2.0**-q
        s += float(counts[q + 1]) * 2.0**-q / float(np.expm1(u))
    return s


def _ertl_mle_host(counts: np.ndarray, cfg: HLLConfig) -> float:
    m = cfg.m
    q = cfg.max_rank - 1
    if counts[0] == m:
        return 0.0
    if counts[q + 1] == m:
        return math.inf
    # seed the bracket from the improved estimator and expand geometrically
    x0 = _ertl_improved_host(counts, cfg) / m
    if not (0.0 < x0 < math.inf):
        x0 = 1.0
    lo = hi = x0
    while _mle_dlogl_host(hi, counts, q) > 0.0 and hi < 2.0**80:
        hi *= 2.0
    while _mle_dlogl_host(lo, counts, q) < 0.0 and lo > 2.0**-80:
        lo *= 0.5
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if mid == lo or mid == hi:  # float64 exhausted
            break
        if _mle_dlogl_host(mid, counts, q) > 0.0:
            lo = mid
        else:
            hi = mid
    return m * 0.5 * (lo + hi)


def _mle_dlogl_device(x: torch.Tensor, counts: torch.Tensor, q: int):
    pw = _pow2_weights(1, q + 1, counts)  # (q,)
    t = pw * (1.0 / torch.expm1(x[..., None] * pw) - 1.0)  # (..., q)
    ck = counts[..., 1 : q + 1]
    s = torch.sum(torch.where(ck > 0, ck * t, 0.0), dim=-1)
    tq = (2.0**-q) / torch.expm1(x * (2.0**-q))
    cq1 = counts[..., q + 1]
    return s + torch.where(cq1 > 0, cq1 * tq, 0.0) - counts[..., 0]


def _ertl_mle_device(counts: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    m = float(cfg.m)
    q = cfg.max_rank - 1
    mid0 = torch.log2(_ertl_improved_device(counts, cfg) / m)
    # 40 bisections over a 2^10-wide log2 bracket around the improved seed:
    # terminal interval 2^-30, below float32 resolution.
    lo, hi = mid0 - 5.0, mid0 + 5.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        going_up = _mle_dlogl_device(torch.exp2(mid), counts, q) > 0.0
        lo, hi = torch.where(going_up, mid, lo), torch.where(going_up, hi, mid)
    est = m * torch.exp2(0.5 * (lo + hi))
    # degenerate sketches never enter the bisection result
    est = torch.where(counts[..., 0] >= m, 0.0, est)
    return torch.where(counts[..., q + 1] >= m, torch.inf, est)


register_estimator(
    "original",
    _original_host,
    _original_device,
    doc="Flajolet harmonic mean + empirical small/large-range corrections "
    "(paper Algorithm 1); host path bit-compatible with the seed.",
)
register_estimator(
    "ertl_improved",
    _ertl_improved_host,
    _ertl_improved_device,
    doc="Ertl improved raw estimator (1702.01284 Alg. 6): sigma/tau tail "
    "corrections, no empirical thresholds, no LC transition bump.",
)
register_estimator(
    "ertl_mle",
    _ertl_mle_host,
    _ertl_mle_device,
    doc="Ertl Poisson maximum-likelihood estimator: bisection on the "
    "concave log-likelihood derivative over the histogram.",
)


# ----------------------------------------------------------------------------
# dispatch: the public finalization entry points
# ----------------------------------------------------------------------------


def resolve_estimator(estimator: Optional[str]) -> str:
    """None -> the package-wide default."""
    return DEFAULT_ESTIMATOR if estimator is None else estimator


def estimate_from_histogram(
    counts, cfg: HLLConfig, estimator: Optional[str] = None
) -> float:
    """Exact host finalization of a precomputed histogram -- O(H - p)."""
    estimator = resolve_estimator(estimator)
    counts = _to_numpy(counts)
    if counts.shape != (histogram_size(cfg),):
        raise ValueError(
            f"expected a ({histogram_size(cfg)},) histogram, got {counts.shape}"
        )
    if int(counts.sum()) != cfg.m:
        raise ValueError(
            f"histogram sums to {int(counts.sum())}, expected m={cfg.m}"
        )
    return float(get_estimator(estimator).host(counts, cfg))


def estimate(
    registers, cfg: HLLConfig, estimator: Optional[str] = None
) -> float:
    """Phase 4, host-exact: histogram the registers, then finalize."""
    name = resolve_estimator(estimator)
    # finalization time per estimator (DESIGN.md §15) -- the "estimate"
    # axis reuses the dispatch-seam shape the backend registries get from
    # plan.register_*, with the estimator name in the backend slot
    with obs_metrics.seam("estimate", name):
        counts = register_histogram_host(registers, cfg)
        return float(get_estimator(name).host(counts, cfg))


def _estimate_device(
    registers: torch.Tensor, cfg: HLLConfig, estimator: str
) -> torch.Tensor:
    with tracing.region("sketch.estimate.histogram"):
        if estimator in _kernel.FINALIZED and _kernel.kernel_takes(registers.device, registers.dtype):
            return _kernel.hll_estimate(registers, cfg, estimator)  # the launch finalizes too
        counts = register_histogram(registers, cfg).to(torch.float32)
    with tracing.region("sketch.estimate.finalize"):
        return get_estimator(estimator).device(counts, cfg)


def estimate_device(
    registers: torch.Tensor,
    cfg: HLLConfig,
    estimator: Optional[str] = None,
) -> torch.Tensor:
    """Float32 estimate of one (m,) sketch on its device (telemetry path)."""
    validate_registers(registers, cfg, batched=False)
    name = resolve_estimator(estimator)
    with obs_metrics.seam("estimate", name):
        return _estimate_device(registers, cfg, name)


def estimate_many(
    register_bank: torch.Tensor,
    cfg: HLLConfig,
    estimator: Optional[str] = None,
) -> torch.Tensor:
    """Batched device finalization: (..., m) bank -> (...,) float32.

    One pass for the whole bank, on the bank's device.  Matches per-sketch
    :func:`estimate_device` to float32 tolerance.
    """
    validate_registers(register_bank, cfg, batched=True)
    name = resolve_estimator(estimator)
    with obs_metrics.seam("estimate", name):
        return _estimate_device(register_bank, cfg, name)
