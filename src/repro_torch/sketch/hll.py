"""HyperLogLog -- the paper's Algorithm 1 on PyTorch tensors.

Port of ``repro/sketch/hll.py``.  Four phases (paper §III):
  1. Hashing      -- Murmur3, 32- or 64-bit (murmur3.py).
  2. Initialization -- alpha_m bias constant, m = 2^p zeroed registers.
  3. Aggregation  -- idx = top p hash bits, rank = CLZ(remaining bits)+1,
                    M[idx] = max(M[idx], rank).
  4. Computation  -- harmonic-mean raw estimate + small/large-range
                    correction, dispatched through estimators.py.

The functions here are the plain versions: ``update`` is one
``scatter_reduce_`` with ``amax``.  The CUDA kernels in
``repro_torch/kernels`` compute the same registers on the card.

Entry points run on the card unless the caller asks for the CPU:
``init_registers(cfg)`` and every carrier constructor default to
``torch.device("cuda")`` and raise when no card is present.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.sketch import murmur3, u64

REGISTER_DTYPE = torch.uint8


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def as_items(items, device=None) -> torch.Tensor:
    """A flat int32 tensor of items holding each item's uint32 bits.

    Accepts a tensor (kept on its device unless ``device`` is given) or
    anything numpy takes (placed on ``device``, the card by default).
    Integers wider than 32 bits keep their low 32 bits, as the reference's
    ``astype(uint32)`` does.
    """
    if isinstance(items, torch.Tensor):
        x = items.reshape(-1)
        if device is not None:
            x = x.to(resolve_device(device))
        if x.dtype == torch.uint32:
            return x.view(torch.int32)
        if x.dtype == torch.int32:
            return x
        if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
            raise TypeError(f"items must be integers, got {x.dtype}")
        x = x.to(torch.int64) & u64.MASK32
        return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    x = np.asarray(items).reshape(-1)
    if not np.issubdtype(x.dtype, np.integer):
        raise TypeError(f"items must be integers, got {x.dtype}")
    x = x.astype(np.uint32, copy=False).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))


def alpha(m: int) -> float:
    """Bias-correction constant (Algorithm 1, lines 2-3)."""
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


@dataclasses.dataclass(frozen=True)
class HLLConfig:
    """Static sketch parameters; the paper explores (p,H) in {14,16}x{32,64}."""

    p: int = 16  # precision: m = 2^p buckets
    hash_bits: int = 64  # H: 32 or 64
    seed: int = 0

    def __post_init__(self):
        if not 4 <= self.p <= 16:
            raise ValueError(f"p must be in [4,16], got {self.p}")
        if self.hash_bits not in (32, 64):
            raise ValueError(f"hash_bits must be 32 or 64, got {self.hash_bits}")
        if not 0 <= self.seed < 1 << 64:
            # keeps the serialized header (uint64 seed) total
            raise ValueError(f"seed must be a uint64, got {self.seed}")

    @property
    def m(self) -> int:
        return 1 << self.p

    @property
    def max_rank(self) -> int:
        # paper eq. (2): rank <= H - p + 1
        return self.hash_bits - self.p + 1

    @property
    def register_bits(self) -> int:
        # paper eq. (3): ceil(log2(H - p + 1)) bits per register
        return math.ceil(math.log2(self.hash_bits - self.p + 1))

    @property
    def memory_footprint_bits(self) -> int:
        # paper eq. (3): B = 2^p * ceil(log2(H - p + 1))
        return self.m * self.register_bits


def init_registers(cfg: HLLConfig, device=None) -> torch.Tensor:
    """Phase 2: m zeroed bucket counters (on the card unless told otherwise)."""
    return torch.zeros((cfg.m,), dtype=REGISTER_DTYPE, device=resolve_device(device))


def hash_index_rank(
    items: torch.Tensor, cfg: HLLConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phases 1 + 3a: hash each item, split into (bucket index, rank).

    idx  = first p bits of the hash (Algorithm 1 line 7)
    rank = leading-zero count of the remaining H-p bits, + 1 (line 9),
           capped at H - p + 1 when the remainder is all-zero.
    Returns (idx int32 in [0, m), rank int32 in [1, H-p+1]), each shaped
    like ``items``.
    """
    p = cfg.p
    if cfg.hash_bits == 32:
        h = murmur3.murmur3_32(items, cfg.seed)
        idx = h >> (32 - p)
        clz_w = u64.clz32((h << p) & u64.MASK32)  # remaining bits at the top
        rank = torch.clamp(clz_w, max=32 - p) + 1
    else:
        h = murmur3.murmur3_64(items, cfg.seed)
        idx = u64.shr(h, 64 - p)
        clz_w = u64.clz(h << p)
        rank = torch.clamp(clz_w, max=64 - p) + 1
    return idx.to(torch.int32), rank.to(torch.int32)


def update(
    registers: torch.Tensor, items: torch.Tensor, cfg: HLLConfig
) -> torch.Tensor:
    """Phase 3: aggregate a batch of items into the registers (plain version).

    One scatter-max of the uint8 ranks into a copy of the registers; items
    may have any shape and are flattened.
    """
    idx, rank = hash_index_rank(items.reshape(-1), cfg)
    return registers.clone().scatter_reduce_(
        0, idx.to(torch.int64), rank.to(REGISTER_DTYPE), "amax"
    )


def merge(*register_arrays: torch.Tensor) -> torch.Tensor:
    """The paper's 'Merge buckets' fold: element-wise max across sketches."""
    out = register_arrays[0]
    for r in register_arrays[1:]:
        out = torch.maximum(out, r)
    return out


# ----------------------------------------------------------------------------
# Phase 4 -- computation, dispatched through the estimator registry
# ----------------------------------------------------------------------------
#
# The imports are deferred because estimators.py imports HLLConfig/alpha
# from here.


def estimate(
    registers, cfg: HLLConfig, estimator: Optional[str] = None
) -> float:
    """Phase 4: exact host-side cardinality estimate."""
    from repro_torch.sketch import estimators as _estimators

    return _estimators.estimate(registers, cfg, estimator=estimator)


def estimate_device(
    registers: torch.Tensor, cfg: HLLConfig, estimator: Optional[str] = None
) -> torch.Tensor:
    """Float32 estimate on the registers' device, for in-step telemetry."""
    from repro_torch.sketch import estimators as _estimators

    return _estimators.estimate_device(registers, cfg, estimator=estimator)


def standard_error(cfg: HLLConfig) -> float:
    """Theoretical HLL standard error 1.04/sqrt(m) (paper §III)."""
    return 1.04 / math.sqrt(cfg.m)


def cardinality(
    items,
    cfg: Optional[HLLConfig] = None,
    estimator: Optional[str] = None,
    device=None,
) -> float:
    """Sketch a whole array and return the exact-finalized estimate.

    The device is the items tensor's own, or ``device`` (the card by
    default) for anything else.
    """
    cfg = cfg or HLLConfig()
    if device is None and isinstance(items, torch.Tensor):
        device = items.device
    x = as_items(items, resolve_device(device))
    regs = update(init_registers(cfg, x.device), x, cfg)
    return estimate(regs, cfg, estimator=estimator)
