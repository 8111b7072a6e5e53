"""sparse_scatter: dedup a (row, bucket, rank) triple stream into cells.

Replaces the TPU kernel ``repro/kernels/sparse_scatter.py::sparse_scatter_coo``
(``_sparse_kernel``), the scatter phase of HybridBank compaction
(DESIGN.md §12).  The CUDA source is ``csrc/sparse_scatter.cu``.

The TPU kernel keeps a row block's ``row_block * m`` int32 cells in VMEM and
merges by a chunked one-hot compare-reduce, which caps a block at 4096 cells
(p <= 12), then counts each row's distinct buckets by a popcount over the
block.  On Hopper one thread per triple raises its cell ``row * m + bucket``
with a native 32-bit ``atomicMax``, and the thread that finds the old value
0 adds one to its row's count, so the count is exact in the same pass; any
rows and p <= 16 work.

Drop rule: entries with a row outside [0, rows), a bucket outside [0, m)
or a rank <= 0 change nothing (padding and foreign rows are never clamped
into a neighbour).  What bounds it on the H100: 12 B of stream per triple
plus 4 B per cell written (the zeroed (rows, m) int32 output) at 3.35 TB/s;
the atomics themselves land in L2.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]


def _check(row, bucket, rank, rows: int, m: int):
    flat = [t.reshape(-1).contiguous() for t in (row, bucket, rank)]
    if any(t.dtype != torch.int32 for t in flat):
        raise TypeError("row, bucket and rank must be int32")
    if not flat[0].numel() == flat[1].numel() == flat[2].numel():
        raise ValueError("row, bucket and rank must have the same length")
    if rows < 0 or m < 1:
        raise ValueError(f"need rows >= 0 and m >= 1, got rows={rows}, m={m}")
    if rows * m >= 1 << 31:
        raise ValueError(f"cell space rows*m = {rows}*{m} overflows int32 cell ids")
    return flat


def sparse_scatter_coo_plain(
    row: torch.Tensor, bucket: torch.Tensor, rank: torch.Tensor, rows: int, m: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: one ``scatter_reduce_`` with ``amax`` into
    zeroed cells, and a count of the nonzero cells of each row.

    Dropped entries are routed to a trailing cell that is cut off.
    """
    row, bucket, rank = _check(row, bucket, rank, rows, m)
    valid = (row >= 0) & (row < rows) & (bucket >= 0) & (bucket < m) & (rank > 0)
    cell = torch.where(valid, row.to(torch.int64) * m + bucket, rows * m)
    cells = torch.zeros(rows * m + 1, dtype=torch.int32, device=row.device)
    cells.scatter_reduce_(0, cell, torch.where(valid, rank, 0), "amax")
    cells = cells[: rows * m].reshape(rows, m)
    return cells, (cells > 0).sum(dim=1, dtype=torch.int32)


def sparse_scatter_coo(
    row: torch.Tensor, bucket: torch.Tensor, rank: torch.Tensor, rows: int, m: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, m) int32 max-rank cells (0 = empty) and (rows,) int32 distinct
    bucket counts of an int32 triple stream.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if all(t.device.type == "cpu" for t in (row, bucket, rank)):
        return sparse_scatter_coo_plain(row, bucket, rank, rows, m)
    row, bucket, rank = _check(row, bucket, rank, rows, m)
    device = _build.require_cuda(row, bucket, rank)
    cells = torch.zeros((rows, m), dtype=torch.int32, device=device)
    distinct = torch.zeros((rows,), dtype=torch.int32, device=device)
    if row.numel() == 0 or rows == 0:
        return cells, distinct
    fn = _build.function("sparse_scatter", "sparse_scatter_launch", _ARGTYPES)
    with torch.cuda.device(device):
        err = fn(
            row.data_ptr(), bucket.data_ptr(), rank.data_ptr(), row.numel(), rows, m,
            cells.data_ptr(), distinct.data_ptr(), _build.stream(device),
        )
    _build.check("sparse_scatter", err, "sparse_scatter_coo")
    sparse_scatter_coo.launches += 1
    return cells, distinct


sparse_scatter_coo.launches = 0
