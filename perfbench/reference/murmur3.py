"""Murmur3 of 32-bit items in plain PyTorch: the benchmark's frozen copy.

Written from the published algorithm (Appleby's MurmurHash3), not taken
from the program, so that a change to the program's hash cannot move the
yardstick:

* ``hash64``: h1 of MurmurHash3_x64_128 of each item as a 4-byte
  little-endian key, h1 and h2 both seeded with the 64-bit seed;
* ``hash32``: MurmurHash3_x86_32 of the same key, seeded with the low 32
  bits of the seed.

Arithmetic runs in int64 tensors: multiplication and addition wrap modulo
2^64, so they give the uint64 bits unchanged, and a logical right shift is
an arithmetic shift followed by a mask.  Items are any integer tensor; each
is taken as its low 32 bits.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


def _i64(value: int) -> int:
    """The int64 whose bits are the uint64 ``value``."""
    value &= M64
    return value - (1 << 64) if value >> 63 else value


def lsr64(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of uint64 bits held in int64, 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotl64(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x << n) | lsr64(x, 64 - n)


def _fmix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ lsr64(h, 33)
    h = h * _i64(0xFF51AFD7ED558CCD)
    h = h ^ lsr64(h, 33)
    h = h * _i64(0xC4CEB9FE1A85EC53)
    return h ^ lsr64(h, 33)


def hash64(items: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """h1 of MurmurHash3_x64_128 of each item (4-byte key): uint64 bits in int64."""
    s = _i64(seed)
    k1 = items.to(torch.int64) & M32
    k1 = k1 * _i64(0x87C37B91114253D5)
    k1 = _rotl64(k1, 31)
    k1 = k1 * _i64(0x4CF5AD432745937F)
    # the 4-byte key is all tail: h1 ^= k1, then both halves take len = 4
    h1 = (k1 ^ s) ^ 4
    h2 = torch.full_like(h1, s ^ 4)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    return h1 + h2


def _rotl32(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & M32


def hash32(items: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """MurmurHash3_x86_32 of each item (4-byte key): the uint32 in int64."""
    k = items.to(torch.int64) & M32
    k = (k * 0xCC9E2D51) & M32
    k = _rotl32(k, 15)
    k = (k * 0x1B873593) & M32
    h = k ^ (seed & M32)
    h = _rotl32(h, 13)
    h = (h * 5 + 0xE6546B64) & M32
    h = h ^ 4
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)
