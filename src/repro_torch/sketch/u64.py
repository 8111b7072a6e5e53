"""64-bit unsigned helpers on int64 tensors.

The reference carries every 64-bit quantity as a pair of uint32 limbs
because the TPU has no 64-bit integer datapath (``repro/sketch/u64.py``).
PyTorch has native int64, so here a 64-bit hash is one int64 tensor that
holds the uint64 bit pattern, and only two pieces of the limb library
survive:

* ``clz32`` / ``clz``: count leading zeros, which PyTorch has no operator
  for;
* the (hi, lo) limb add of the exact item counters, which count to 2^64
  and so do not fit an int64 (``add``), and their conversion to and from
  host uint64 arrays (``to_numpy``, ``from_numpy``).

Hazard: on the CPU, ``>>`` and ``<<`` on ``torch.uint64`` raise
``NotImplementedError``, while int64 ``*`` and ``+`` wrap modulo 2^64.  So
the plain hash runs in int64: ``*``, ``+``, ``^`` and ``<<`` give the uint64
bits unchanged, and a logical right shift is an arithmetic one followed by a
mask (:func:`shr`).
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1


def signed64(value: int) -> int:
    """The int64 whose bits are the uint64 ``value`` (for tensor constants)."""
    value &= MASK64
    return value - (1 << 64) if value >> 63 else value


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64-held uint64 bits by a static 0 < n < 64."""
    if not 0 < n < 64:
        raise ValueError(f"shift must be in (0, 64), got {n}")
    return (x >> n) & ((1 << (64 - n)) - 1)


def rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate int64-held uint64 bits left by a static 0 < n < 64 (ROTL64)."""
    return (x << n) | shr(x, 64 - n)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of uint32 values held in an int64 tensor.

    A 5-step binary search, exact for every input.  Returns int32 in
    [0, 32].
    """
    x = x.to(torch.int64) & MASK32
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for step in (16, 8, 4, 2, 1):
        high = x >= (1 << (32 - step))
        n = torch.where(high, n, n + step)
        x = torch.where(high, x, (x << step) & MASK32)
    # all-zero input: the loop above counted 31, fix to 32.
    return torch.where(x == 0, 32, n).to(torch.int32)


def clz(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of int64-held uint64 bits; int32 in [0, 64]."""
    hi = shr(x, 32)
    return torch.where(hi != 0, clz32(hi), 32 + clz32(x & MASK32))


def add(a: torch.Tensor, b) -> torch.Tensor:
    """64-bit add modulo 2^64 on (..., 2) int64 (hi, lo) uint32 limb pairs.

    ``b`` is another limb tensor or a python int (added without a copy to
    the device).
    """
    if isinstance(b, int):
        b_hi, b_lo = (b >> 32) & MASK32, b & MASK32
    else:
        b_hi, b_lo = b[..., 0], b[..., 1]
    lo = a[..., 1] + b_lo
    hi = (a[..., 0] + b_hi + (lo >> 32)) & MASK32
    return torch.stack([hi, lo & MASK32], dim=-1)


def limbs(values: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 values -> (..., 2) int64 (hi, lo) limb pairs."""
    return torch.stack([values >> 32, values & MASK32], dim=-1)


def _device(device) -> torch.device:
    # hll imports this module: its device rule is imported at the call
    from repro_torch.sketch.hll import resolve_device

    return resolve_device(device)


def from_py(value: int, device=None) -> torch.Tensor:
    """A python int < 2^64 -> (2,) int64 (hi, lo) limb pair on ``device`` (the card by default)."""
    value &= MASK64
    return torch.tensor([value >> 32, value & MASK32], dtype=torch.int64, device=_device(device))


def to_py(pair) -> int:
    """A (2,) limb pair -> python int."""
    hi, lo = (int(v) for v in pair.tolist())
    return (hi << 32) | lo


def to_numpy(limbs: torch.Tensor) -> np.ndarray:
    """(..., 2) int64 (hi, lo) limb pairs -> (...) uint64 on the host."""
    host = limbs.cpu().numpy().astype(np.uint64)
    return (host[..., 0] << np.uint64(32)) | host[..., 1]


def from_numpy(values, device=None) -> torch.Tensor:
    """(...) uint64 values -> (..., 2) int64 (hi, lo) limb pairs on ``device`` (the card by default)."""
    values = np.asarray(values, dtype=np.uint64)
    limbs = np.stack([values >> np.uint64(32), values & np.uint64(MASK32)], axis=-1)
    return torch.from_numpy(limbs.astype(np.int64)).to(_device(device))
