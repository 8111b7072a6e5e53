"""Approximate set algebra over HLL sketches (beyond-paper extension).

Port of ``repro/sketch/setops.py``.  The max-lattice gives:

  union        exact at sketch level: |A ∪ B| = estimate(merge(A, B))
  intersection inclusion-exclusion: |A ∩ B| = |A| + |B| - |A ∪ B|
               (error grows with the Jaccard disparity -- reported alongside)
  difference   |A \\ B| = |A ∪ B| - |B|

Each operation consumes only the register arrays and finalizes on the host
through the estimator registry (``estimator=``, DESIGN.md §8).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.sketch import hll
from repro_torch.sketch.hll import HLLConfig


def _registers(x) -> torch.Tensor:
    """Accept either a raw (m,) register tensor or a HyperLogLog carrier."""
    return getattr(x, "registers", x)


def union_estimate(
    a, b, cfg: HLLConfig, estimator: Optional[str] = None
) -> float:
    return hll.estimate(
        hll.merge(_registers(a), _registers(b)), cfg, estimator=estimator
    )


def intersection_estimate(
    a, b, cfg: HLLConfig, estimator: Optional[str] = None
) -> Tuple[float, float]:
    """Returns (|A ∩ B| estimate, standard-error bound of the estimate).

    Inclusion-exclusion over three HLL estimates; the absolute error is
    bounded by the sum of the three absolute errors, so the *relative*
    error blows up for small intersections -- the returned bound makes that
    explicit so callers can reject unreliable readings.
    """
    a, b = _registers(a), _registers(b)
    ea = hll.estimate(a, cfg, estimator=estimator)
    eb = hll.estimate(b, cfg, estimator=estimator)
    eu = union_estimate(a, b, cfg, estimator=estimator)
    inter = max(0.0, ea + eb - eu)
    sigma = hll.standard_error(cfg)
    err_abs = sigma * (ea + eb + eu)
    return inter, err_abs


def difference_estimate(
    a, b, cfg: HLLConfig, estimator: Optional[str] = None
) -> float:
    """|A \\ B| >= 0 via union."""
    return max(
        0.0,
        union_estimate(a, b, cfg, estimator=estimator)
        - hll.estimate(_registers(b), cfg, estimator=estimator),
    )


def jaccard_estimate(
    a, b, cfg: HLLConfig, estimator: Optional[str] = None
) -> float:
    # inclusion-exclusion from one union merge + three finalizations
    a, b = _registers(a), _registers(b)
    ea = hll.estimate(a, cfg, estimator=estimator)
    eb = hll.estimate(b, cfg, estimator=estimator)
    eu = union_estimate(a, b, cfg, estimator=estimator)
    if eu <= 0:
        return float("nan")
    return max(0.0, ea + eb - eu) / eu
