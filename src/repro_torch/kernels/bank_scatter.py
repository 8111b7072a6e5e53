"""bank_scatter: keyed scatter-max of a (key, bucket, rank) stream into a bank.

Replaces the TPU kernel ``repro/kernels/bank_scatter.py::bank_scatter_max``
(``_bank_kernel``).  The CUDA source is ``csrc/bank_scatter.cu``.

The TPU kernel tiles the bank over row blocks held in VMEM and merges by a
one-hot compare-reduce, which caps a block at 4096 cells
(``MAX_BLOCK_CELLS``, hence p <= 12).  On Hopper each item raises its cell
``key * m + bucket`` of the uint8 bank in place with a compare-and-swap on
the containing 32-bit word, so any B and p <= 16 work.  The bank stays
uint8: an int32 copy of a B = 1024, p = 16 bank would be 256 MiB against
its own 64 MiB.

Drop rule (DESIGN.md §9), checked by the kernel itself: keys outside
[0, B), buckets outside [0, m) and ranks outside [1, 255] are no-ops --
never clamped into a neighbouring row.  What bounds it on the H100: the
bank copy the functional result needs (B*m bytes read and written) plus
12 B of stream per item, at 3.35 TB/s; the byte updates themselves are
random L2/HBM read-modify-writes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.sketch import hll

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check(registers, keys, idx, rank):
    if registers.dim() != 2 or registers.dtype != hll.REGISTER_DTYPE:
        raise ValueError(
            f"registers must be a (B, m) uint8 bank, got {tuple(registers.shape)} {registers.dtype}"
        )
    if registers.numel() % 4:
        raise ValueError(f"the kernel updates 4-byte words; B*m must divide by 4, got {registers.numel()}")
    flat = [t.reshape(-1).contiguous() for t in (keys, idx, rank)]
    if any(t.dtype != torch.int32 for t in flat):
        raise TypeError("keys, idx and rank must be int32")
    if not flat[0].numel() == flat[1].numel() == flat[2].numel():
        raise ValueError("keys, idx and rank must have the same length")
    return flat


def bank_scatter_max_plain(
    registers: torch.Tensor, keys: torch.Tensor, idx: torch.Tensor, rank: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: one ``scatter_reduce_`` with ``amax``.

    Dropped entries are routed to a trailing cell that is cut off, never
    clamped into a neighbour.
    """
    keys, idx, rank = _check(registers, keys, idx, rank)
    rows, m = registers.shape
    valid = (keys >= 0) & (keys < rows) & (idx >= 0) & (idx < m) & (rank >= 1) & (rank <= 255)
    cells = torch.where(valid, keys.to(torch.int64) * m + idx, rows * m)
    flat = torch.cat([registers.reshape(-1), registers.new_zeros(1)])
    flat.scatter_reduce_(0, cells, torch.where(valid, rank, 0).to(hll.REGISTER_DTYPE), "amax")
    return flat[: rows * m].reshape(rows, m)


def bank_scatter_max(
    registers: torch.Tensor, keys: torch.Tensor, idx: torch.Tensor, rank: torch.Tensor
) -> torch.Tensor:
    """Fold a (key, bucket, rank) int32 stream into a copy of a (B, m) uint8 bank.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if all(t.device.type == "cpu" for t in (registers, keys, idx, rank)):
        return bank_scatter_max_plain(registers, keys, idx, rank)
    keys, idx, rank = _check(registers, keys, idx, rank)
    device = _build.require_cuda(registers, keys, idx, rank)
    rows, m = registers.shape
    out = registers.clone(memory_format=torch.contiguous_format)
    if keys.numel() == 0:
        return out
    fn = _build.function("bank_scatter", "bank_scatter_launch", _ARGTYPES)
    with torch.cuda.device(device):
        err = fn(
            out.data_ptr(), keys.data_ptr(), idx.data_ptr(), rank.data_ptr(), keys.numel(),
            rows, m, _build.stream(device),
        )
    _build.check("bank_scatter", err, "bank_scatter_max")
    bank_scatter_max.launches += 1
    return out


bank_scatter_max.launches = 0
