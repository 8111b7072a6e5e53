"""HyperLogLog in plain PyTorch: the benchmark's reference semantics.

The paper's Algorithm 1 (arXiv:2005.13332 §III) with the estimator of
Flajolet et al., written for the benchmark and independent of the program:

* ``index_rank``: bucket = the top p bits of the H-bit hash; rank = the
  leading zeros of the remaining H - p bits, plus one (H - p + 1 when they
  are all zero);
* the register max: registers[cell] = max(registers[cell], rank), in int32,
  one ``scatter_reduce_`` a block;
* ``estimates``: the "original" estimator of each row's registers, in
  float64 (``precision="exact"``) or in bfloat16 (``precision="low"``, the
  control): raw = alpha_m m^2 / sum_j 2^-M[j]; linear counting m ln(m / V)
  where raw <= 5m/2 and V registers are zero; for H = 32 the large-range
  correction above 2^32 / 30.

``precision="low"`` also hashes with H = 32 where the configuration states
64: the control puts each stage one precision below the configuration's.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import murmur3

BLOCK = 1 << 24  # items hashed at a time: ~1 GiB of int64 temporaries at most


def hash_bits_of(config: dict, precision: str) -> int:
    """The hash width the reference runs: the configuration's, or 32 for the control."""
    if precision not in ("exact", "low"):
        raise ValueError(f"precision is 'exact' or 'low', got {precision!r}")
    return 32 if precision == "low" else int(config["hash_bits"])


def _bit_length(w: torch.Tensor) -> torch.Tensor:
    """Bits needed for each non-negative int64 below 2^63 (0 for 0)."""
    n = torch.zeros_like(w)
    for step in (32, 16, 8, 4, 2, 1):
        big = w >= (1 << step)
        n = n + big.to(torch.int64) * step
        w = torch.where(big, w >> step, w)
    return n + (w > 0).to(torch.int64)


def index_rank(items: torch.Tensor, p: int, hash_bits: int, seed: int):
    """(bucket int64 in [0, 2^p), rank int32 in [1, H - p + 1]) of each item."""
    width = hash_bits - p
    if hash_bits == 64:
        h = murmur3.hash64(items, seed)
        idx = murmur3.lsr64(h, width)
    elif hash_bits == 32:
        h = murmur3.hash32(items, seed)
        idx = h >> width
    else:
        raise ValueError(f"hash_bits is 32 or 64, got {hash_bits}")
    rest = h & ((1 << width) - 1)
    rank = width - _bit_length(rest) + 1
    return idx, rank.to(torch.int32)


def alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def histograms(registers: torch.Tensor, p: int, hash_bits: int) -> torch.Tensor:
    """(rows, m) int registers -> (rows, H - p + 2) int64 counts of each value."""
    rows, m = registers.shape
    k = hash_bits - p + 2
    flat = registers.to(torch.int64) + k * torch.arange(rows, device=registers.device)[:, None]
    return torch.bincount(flat.reshape(-1), minlength=rows * k).reshape(rows, k)


def estimates(registers: torch.Tensor, p: int, hash_bits: int, precision: str = "exact") -> torch.Tensor:
    """(rows,) "original" estimates of (rows, m) registers: float64, or bfloat16 for the control."""
    dtype = torch.bfloat16 if precision == "low" else torch.float64
    m = 1 << p
    counts = histograms(registers, p, hash_bits).to(dtype)
    weights = torch.exp2(-torch.arange(counts.shape[1], dtype=torch.float64, device=counts.device)).to(dtype)
    harmonic = (counts * weights).sum(dim=1)
    raw = torch.tensor(alpha(m) * m * m, dtype=dtype, device=counts.device) / harmonic
    zeros = counts[:, 0]
    linear = m * torch.log(torch.tensor(float(m), dtype=dtype, device=counts.device) / torch.clamp(zeros, min=1))
    out = torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)
    if hash_bits == 32:
        two32 = float(1 << 32)
        large = -two32 * torch.log1p(-(torch.clamp(raw, max=two32) / two32))
        large = torch.where(raw >= two32, math.inf, large)
        out = torch.where(raw > two32 / 30.0, large, out)
    return out


def pass_calls(batches: int, calls: int) -> tuple:
    """(calls in the pass the window ended in, whether a whole pass came
    before it), for ``calls`` calls that take batch i % batches, a pass of
    the pool to a state opened empty."""
    return (calls - 1) % batches + 1, calls > batches
