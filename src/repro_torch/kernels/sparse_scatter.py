"""sparse_scatter: dedup a (row, bucket, rank) triple stream into cells.

Replaces the TPU kernel ``repro/kernels/sparse_scatter.py::sparse_scatter_coo``
(``_sparse_kernel``), the scatter phase of HybridBank compaction
(DESIGN.md §12).  The CUDA source is ``csrc/sparse_scatter.cu``.

The TPU kernel keeps a row block's ``row_block * m`` int32 cells in VMEM and
merges by a chunked one-hot compare-reduce, which caps a block at 4096 cells
(p <= 12), then counts each row's distinct buckets by a popcount over the
block.  The Hopper kernel keeps the same thing on chip -- a block-resident
tile of cells, written once and counted in place -- and reaches it by
partitioning the stream by tile first: a block per slice of the stream
sorts its triples by tile in shared memory and writes them out coalesced;
then one block per tile gathers the tile's segment of every slice, takes
the max in shared memory and writes every cell of the tile.  ``tile_plan``
cuts the cell space: tiles of at most 2^14 cells holding whole rows where
m <= 2^14, else a row spanning m / 2^14 tiles; ``stream_split`` cuts the
stream into slices.  A plan with more tiles than a shared histogram holds,
or a stream of more slices than a tile block gathers from, takes the
global path (atomicMax on zeroed cells, first touch counts the row).

Drop rule: entries with a row outside [0, rows), a bucket outside [0, m)
or a rank <= 0 change nothing (padding and foreign rows are never clamped
into a neighbour).  What bounds it on the H100: 12 B of stream per triple
plus 4 B per cell and per row written once, at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.obs import costs

TILE_CELLS = 1 << 14  # int32 cells a tile holds in shared memory (64 KB)
MAX_TILE_ROWS = 1024  # rows a tile holds at most (its shared row counters)
HIST_TILES = 1 << 14  # tiles a shared histogram holds; more take the global path
MIN_SLICE, MAX_SLICE = 1 << 10, 1 << 14  # triples a slice holds in shared memory
MAX_SLICES = 4096  # slices a tile block gathers from; more take the global path

_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]
_TILED_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 6


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the kernel cuts the flat ``rows * m`` cell space into tiles.

    Where m <= TILE_CELLS a tile holds ``rows_per_tile`` whole rows (the
    last tile fewer); else each row spans ``tiles_per_row`` tiles of
    TILE_CELLS cells (its last one ragged where TILE_CELLS does not divide
    m).  ``global_path``: more tiles than a shared histogram holds.
    """

    rows: int
    m: int
    rows_per_tile: int
    tiles_per_row: int
    tiles: int
    global_path: bool

    @property
    def spans_rows(self) -> bool:
        return self.tiles_per_row > 1

    def cells(self, tile: int) -> Tuple[int, int]:
        """The flat cell range [lo, hi) of ``tile``."""
        if self.tiles_per_row == 1:
            lo = tile * self.rows_per_tile
            return lo * self.m, min(self.rows, lo + self.rows_per_tile) * self.m
        row, chunk = divmod(tile, self.tiles_per_row)
        return row * self.m + chunk * TILE_CELLS, row * self.m + min(self.m, (chunk + 1) * TILE_CELLS)


def tile_plan(rows: int, m: int) -> TilePlan:
    """The tile plan of ``rows`` rows of ``m`` cells."""
    if m <= TILE_CELLS:
        per = min(TILE_CELLS // m, MAX_TILE_ROWS)
        tiles_per_row, tiles = 1, -(-rows // per)
    else:
        per, tiles_per_row = 0, -(-m // TILE_CELLS)
        tiles = rows * tiles_per_row
    return TilePlan(rows, m, per, tiles_per_row, tiles, tiles > HIST_TILES)


def stream_split(n: int, sms: int) -> Tuple[int, int]:
    """(per, slices): ``n`` triples cut into slices of ``per`` (a multiple of
    4 in [MIN_SLICE, MAX_SLICE]), two slices an SM where that many fit."""
    per = min(MAX_SLICE, max(MIN_SLICE, -(-n // (2 * sms))))
    per = (per + 3) // 4 * 4
    return per, -(-n // per)


def _cost(n: int, rows: int, m: int):
    """The triples in, the cells and counts out."""
    return 0, 12 * n + 4 * rows * m + 4 * rows


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
    n = row.numel()
    if _build.on_meta(row, bucket, rank):
        costs.kernel("sparse_scatter_coo", *_cost(n, rows, m))
        return (torch.empty((rows, m), dtype=torch.int32, device="meta"),
                torch.empty((rows,), dtype=torch.int32, device="meta"))
    device = _build.require_cuda(row, bucket, rank)
    if n == 0 or rows == 0:
        return (torch.zeros((rows, m), dtype=torch.int32, device=device),
                torch.zeros((rows,), dtype=torch.int32, device=device))
    plan = tile_plan(rows, m)
    per, slices = stream_split(n, _build.sm_count(device))
    if plan.global_path or slices > MAX_SLICES:
        cells = torch.zeros((rows, m), dtype=torch.int32, device=device)
        distinct = torch.zeros((rows,), dtype=torch.int32, device=device)
        _build.launch("sparse_scatter_coo", "sparse_scatter", "sparse_scatter_launch", _ARGTYPES, device,
                      (row.data_ptr(), bucket.data_ptr(), rank.data_ptr(), n, rows, m, cells.data_ptr(),
                       distinct.data_ptr()),
                      *_cost(n, rows, m))
    else:
        # every cell is written by the kernel, and every count where a tile
        # holds its rows; counts of rows spanning tiles are added up
        cells = torch.empty((rows, m), dtype=torch.int32, device=device)
        new = torch.zeros if plan.spans_rows else torch.empty
        distinct = new((rows,), dtype=torch.int32, device=device)
        offsets = torch.empty(slices * (plan.tiles + 1), dtype=torch.int32, device=device)
        wide = torch.empty(slices, dtype=torch.int32, device=device)
        packed = torch.empty(2 * per * slices, dtype=torch.int32, device=device)
        _build.launch("sparse_scatter_coo", "sparse_scatter", "sparse_scatter_tiled_launch", _TILED_ARGTYPES, device,
                      (row.data_ptr(), bucket.data_ptr(), rank.data_ptr(), n, rows, m, plan.rows_per_tile,
                       plan.tiles_per_row, plan.tiles, per, slices, cells.data_ptr(), distinct.data_ptr(),
                       offsets.data_ptr(), wide.data_ptr(), packed.data_ptr()),
                      *_cost(n, rows, m))
    return cells, distinct
