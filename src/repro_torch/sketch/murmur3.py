"""Murmur3 hash functions on PyTorch tensors (plain versions).

Bit-exact ports of ``repro/sketch/murmur3.py``:

* ``murmur3_32`` -- Murmur3_x86_32 of a 4-byte little-endian key; the seed
  is truncated to 32 bits.
* ``murmur3_64`` -- h1 of Murmur3_x64_128 of a 4-byte little-endian key,
  with both h1 and h2 seeded by the full 64-bit seed.

Both take an integer tensor of items and reinterpret each as a uint32
(an int32 item's two's-complement bits; the reference does
``astype(uint32)``).  Arithmetic runs in int64 (see ``u64.py`` for why):
``murmur3_32`` returns the uint32 hash in an int64 tensor, ``murmur3_64``
the uint64 hash's bits in an int64 tensor.  The CUDA kernels hash with
``kernels/csrc/murmur3.cuh`` instead; both are held to the pure-python
``murmur3_*_py`` oracles below.
"""

from __future__ import annotations

import torch

from repro_torch.sketch import u64
from repro_torch.sketch.u64 import MASK32, signed64

# --- Murmur3_x86_32 constants -------------------------------------------------
_C1_32 = 0xCC9E2D51
_C2_32 = 0x1B873593
_FMIX1_32 = 0x85EBCA6B
_FMIX2_32 = 0xC2B2AE35

# --- Murmur3_x64_128 constants, as int64 bit patterns -------------------------
_C1_64 = signed64(0x87C37B91114253D5)
_C2_64 = signed64(0x4CF5AD432745937F)
_FMIX1_64 = signed64(0xFF51AFD7ED558CCD)
_FMIX2_64 = signed64(0xC4CEB9FE1A85EC53)


def as_u32(keys: torch.Tensor) -> torch.Tensor:
    """Integer items -> their uint32 values in an int64 tensor."""
    return keys.to(torch.int64) & MASK32


def _rotl32(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * _FMIX1_32) & MASK32
    h = h ^ (h >> 13)
    h = (h * _FMIX2_32) & MASK32
    return h ^ (h >> 16)


def murmur3_32(keys: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Murmur3_x86_32 of each 32-bit item, treated as a 4-byte LE key."""
    k = as_u32(keys)
    # single 4-byte body block
    k = (k * _C1_32) & MASK32
    k = _rotl32(k, 15)
    k = (k * _C2_32) & MASK32
    h = k ^ (seed & MASK32)
    h = _rotl32(h, 13)
    h = (h * 5 + 0xE6546B64) & MASK32
    # no tail; finalize with len=4
    return fmix32(h ^ 4)


def fmix64(k: torch.Tensor) -> torch.Tensor:
    k = k ^ u64.shr(k, 33)
    k = k * _FMIX1_64
    k = k ^ u64.shr(k, 33)
    k = k * _FMIX2_64
    return k ^ u64.shr(k, 33)


def murmur3_64(keys: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """h1 of Murmur3_x64_128 of each 32-bit item (4-byte LE key).

    A 4-byte key takes the tail path of the x64_128 algorithm:
      k1 = key; k1 *= c1; k1 = rotl(k1,31); k1 *= c2; h1 ^= k1
    then finalization with len=4.  Returns h1's bits as int64.
    """
    seed64 = signed64(seed)
    k1 = as_u32(keys) * _C1_64
    k1 = u64.rotl(k1, 31)
    k1 = k1 * _C2_64
    h1 = (k1 ^ seed64) ^ 4
    h2 = torch.full_like(h1, seed64 ^ 4)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = fmix64(h1)
    h2 = fmix64(h2)
    # (h2 += h1 would complete the 128-bit digest; h1 alone is our hash)
    return h1 + h2


def murmur3_64_py(key: int, seed: int = 0) -> int:
    """Pure-python oracle for murmur3_64 (test ground truth)."""
    mask = (1 << 64) - 1

    def rotl(x: int, n: int) -> int:
        return ((x << n) | (x >> (64 - n))) & mask

    def fmix(k: int) -> int:
        k ^= k >> 33
        k = (k * 0xFF51AFD7ED558CCD) & mask
        k ^= k >> 33
        k = (k * 0xC4CEB9FE1A85EC53) & mask
        k ^= k >> 33
        return k

    h1 = seed & mask
    h2 = seed & mask
    k1 = key & 0xFFFFFFFF
    k1 = (k1 * 0x87C37B91114253D5) & mask
    k1 = rotl(k1, 31)
    k1 = (k1 * 0x4CF5AD432745937F) & mask
    h1 ^= k1
    h1 = (h1 ^ 4) & mask
    h2 = (h2 ^ 4) & mask
    h1 = (h1 + h2) & mask
    h2 = (h2 + h1) & mask
    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = (h1 + h2) & mask
    return h1


def murmur3_32_py(key: int, seed: int = 0) -> int:
    """Pure-python oracle for murmur3_32 (test ground truth)."""
    mask = (1 << 32) - 1

    def rotl(x: int, n: int) -> int:
        return ((x << n) | (x >> (32 - n))) & mask

    h = seed & mask
    k = key & mask
    k = (k * 0xCC9E2D51) & mask
    k = rotl(k, 15)
    k = (k * 0x1B873593) & mask
    h ^= k
    h = rotl(h, 13)
    h = (h * 5 + 0xE6546B64) & mask
    h ^= 4
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & mask
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & mask
    h ^= h >> 16
    return h
