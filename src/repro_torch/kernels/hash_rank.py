"""hash_rank: Murmur3 + split + rank of a flat item stream.

Replaces the TPU kernel ``repro/kernels/hash_rank.py::hash_rank``
(``_hash_rank_kernel``), the paper's pipeline front end (hash function ->
index extractor -> leading zero detector, Fig. 2).  The CUDA source is
``csrc/hash_rank.cu`` with the hash in ``csrc/murmur3.cuh``.

What bounds it on the H100: memory, at 4 B read and 8 B written per item
(3.35 TB/s), unless the tens of integer instructions of the 64-bit hash
per item cost more.  Its design: one item per thread over a grid-stride
loop, coalesced, with the ragged tail masked by the loop bound, so a
stream of any length needs no padding to the TPU's (rows, 128) tiles.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.obs import costs
from repro_torch.sketch import hll
from repro_torch.sketch.hll import HLLConfig

_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_void_p]
)


def _check_items(items: torch.Tensor) -> torch.Tensor:
    if items.dtype == torch.uint32:
        items = items.view(torch.int32)
    if items.dtype != torch.int32:
        raise TypeError(f"items must be int32 or uint32, got {items.dtype}")
    return items.reshape(-1).contiguous()


def _cost(n: int):
    """4 B in, 8 B out an item."""
    return 0, 12 * n


def hash_rank_plain(items: torch.Tensor, cfg: HLLConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``hll.hash_index_rank`` of the stream."""
    return hll.hash_index_rank(_check_items(items), cfg)


def hash_rank(items: torch.Tensor, cfg: HLLConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat int32/uint32 items -> (idx, rank) int32, each of the items' length.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if items.device.type == "cpu":
        return hash_rank_plain(items, cfg)
    items = _check_items(items)
    idx = torch.empty_like(items)
    rank = torch.empty_like(items)
    if _build.on_meta(items):
        costs.kernel("hash_rank", *_cost(items.numel()))
        return idx, rank
    device = _build.require_cuda(items)
    if items.numel() == 0:
        return idx, rank
    _build.launch("hash_rank", "hash_rank", "hash_rank_launch", _ARGTYPES, device,
                  (items.data_ptr(), idx.data_ptr(), rank.data_ptr(), items.numel(), cfg.p, cfg.hash_bits, cfg.seed),
                  *_cost(items.numel()))
    return idx, rank
