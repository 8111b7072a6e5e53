"""Baselines the paper compares against / falls back to.

Port of ``repro/sketch/exact.py``:

* ``exact_distinct``     -- ground-truth distinct count (host, sort-based).
* ``linear_counting``    -- the LC bitmap estimator HLL reverts to at small
                            cardinalities (Algorithm 1 line 15), standalone.
* ``naive_distinct_mem`` -- memory a naive exact set would need (paper §I's
                            motivation: linear in cardinality).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.sketch import murmur3
from repro_torch.sketch.hll import HLLConfig


def exact_distinct(items) -> int:
    """Ground-truth cardinality (host-side)."""
    if isinstance(items, torch.Tensor):
        items = items.detach().cpu().numpy()
    return int(np.unique(np.asarray(items).reshape(-1)).size)


def linear_counting_registers(items: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    """Occupancy bitmap over m = 2^p hash buckets (uint8 0/1)."""
    h = murmur3.murmur3_32(items.reshape(-1), cfg.seed)
    bitmap = torch.zeros((cfg.m,), dtype=torch.uint8, device=items.device)
    return bitmap.index_fill_(0, h >> (32 - cfg.p), 1)


def linear_counting_estimate(bitmap, m: int) -> float:
    if isinstance(bitmap, torch.Tensor):
        bitmap = bitmap.detach().cpu().numpy()
    v = int(m - np.count_nonzero(np.asarray(bitmap)))
    if v == 0:
        return float("inf")  # bitmap saturated; LC undefined
    return m * math.log(m / v)


def naive_distinct_mem_bytes(cardinality: int, item_bytes: int = 4) -> int:
    """Memory of an exact hash-set, the paper's strawman (linear in n)."""
    # 2x load-factor overhead, item + bucket pointer
    return int(cardinality * (item_bytes + 8) * 2)
