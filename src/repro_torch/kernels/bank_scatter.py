"""bank_scatter: keyed scatter-max of a (key, bucket, rank) stream into a bank.

Replaces the TPU kernel ``repro/kernels/bank_scatter.py::bank_scatter_max``
(``_bank_kernel``).  The CUDA source is ``csrc/bank_scatter.cu``.

The TPU kernel tiles the bank over row blocks held in VMEM and merges by a
one-hot compare-reduce, which caps a block at 4096 cells
(``MAX_BLOCK_CELLS``, hence p <= 12).  On Hopper the bank stays uint8 and
the stream is partitioned by tile first, as ``sparse_scatter`` and
``cm_scatter`` do: ``bank_tile_plan`` cuts the bank into tiles of a power
of two of whole rows (at most 2^16 register bytes, 64 KiB of shared
memory: one row at p = 16, 16 at p = 12); a block per slice of the stream
(``stream_split``) sorts its entries by tile, packed in 32 bits as (cell in
tile, rank); a block per work unit copies its tile of the input registers
into shared memory, lands its entries with a shared byte max and stores the
whole tile, so no bank copy runs and the input is never written.  A tile
with more than ``UNIT_ITEMS`` entries (Zipf keys make hot rows) is split
into units over groups of slices; its extra units store partial tiles to
scratch (at most n / UNIT_ITEMS of 64 KiB: 16 MiB at 2^22 entries), which
a fold pass merges into the result by per-byte max.  The plan's limits
and the path rule live here (``bank_scatter_path``);
``bank_scatter_max_global`` runs the previous design, one byte
compare-and-swap an entry into a copy of the bank, at any shape, and
``bank_scatter_max_tiled`` the tiled path at any shape its limits allow.

Drop rule (DESIGN.md §9), checked by the kernels themselves: keys outside
[0, B), buckets outside [0, m) and ranks outside [1, 255] are no-ops --
never clamped into a neighbouring row.  What bounds it on the H100: the
bank read and written once plus 12 B of stream per entry, at 3.35 TB/s;
the tiled path also reads the keys a second time, writes and reads 4 B an
entry of a valid key, and writes and reads the extra units' partial tiles.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparse_scatter import MAX_SLICES, stream_split
from repro_torch.obs import costs
from repro_torch.sketch import hll

TILE_BYTES = 1 << 16  # register bytes a tile holds in shared memory (64 KiB)
HIST_TILES = 1 << 14  # tiles a shared histogram holds; more take the global path
UNIT_ITEMS = 1 << 14  # entries a work unit takes; a tile with more is split
MAX_OFFSETS = 1 << 24  # entries of the (slices, tiles + 1) offsets scratch; more take the global path
# Where the tiled path is faster: banks of at least TILED_MIN_BYTES fed at
# least TILED_MIN_ENTRIES entries.  Measured on an H100 (80GB HBM3, 700 W;
# chip_smoke.py's timing variants, Zipf(1.2) keys, device ms global /
# tiled, on the bank the caller holds after one update of the same traffic;
# on random registers in brackets): (1024, 2^16) at 2^22 entries 0.1506 /
# 0.1199 (0.1239 / 0.1193), (768, 2^16) 0.1328 / 0.1096 (0.1084 /
# 0.1107), (512, 2^16) 0.1193 / 0.1005 (0.0893 / 0.1023), (256, 2^16)
# 0.1021 / 0.0983 (0.0681 / 0.0976); (1024, 2^16) at 2^20 entries 0.0799
# / 0.0927; the banks of the window epoch, the board's flush and
# HybridBank's dense block (1-6.5 MiB, ~2^20 entries) 0.028-0.032 /
# 0.059-0.062.  A smaller bank stays in the 50 MB L2 while the global
# path's byte updates land, and a shorter stream leaves the tiled path's
# fixed passes (the bank streamed through shared memory, five launches)
# unpaid for.
TILED_MIN_BYTES = 32 << 20
TILED_MIN_ENTRIES = 1 << 21

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_TILED_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 8
    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
)


@dataclasses.dataclass(frozen=True)
class BankTilePlan:
    """How the tiled kernel cuts a (B, m) uint8 bank: tiles of
    ``rows_per_tile`` whole rows (the last tile fewer), a power of two, so
    that a key's tile is a shift.  ``global_path``: m past a tile or not a
    multiple of 16 (tiles start on 16-byte boundaries), or more tiles than a
    shared histogram holds.
    """

    rows: int
    m: int
    rows_per_tile: int
    tiles: int
    global_path: bool

    def rows_of(self, tile: int) -> Tuple[int, int]:
        """The row range [lo, hi) of ``tile``."""
        lo = tile * self.rows_per_tile
        return lo, min(self.rows, lo + self.rows_per_tile)


def bank_tile_plan(rows: int, m: int) -> BankTilePlan:
    """The tile plan of a (``rows``, ``m``) bank."""
    if m > TILE_BYTES or m % 16:
        return BankTilePlan(rows, m, 0, 0, True)
    per = 1 << ((TILE_BYTES // m).bit_length() - 1)
    tiles = -(-rows // per)
    return BankTilePlan(rows, m, per, tiles, tiles > HIST_TILES)


def bank_scatter_path(rows: int, m: int, n: int, sms: int) -> str:
    """"tiled" or "global": the path ``bank_scatter_max`` takes for ``n``
    entries into a (``rows``, ``m``) bank on a card of ``sms`` SMs -- the
    global path past the tiled limits and where it measured faster."""
    if rows * m < TILED_MIN_BYTES or n < TILED_MIN_ENTRIES or not tiled_fits(rows, m, n, sms):
        return "global"
    return "tiled"


def tiled_fits(rows: int, m: int, n: int, sms: int) -> bool:
    """Whether the tiled path's limits allow ``n`` entries into a (``rows``,
    ``m``) bank: a plan that fits (``bank_tile_plan``), at most MAX_SLICES
    slices, an offsets scratch of at most MAX_OFFSETS entries."""
    plan = bank_tile_plan(rows, m)
    _, slices = stream_split(n, sms)
    return not plan.global_path and slices <= MAX_SLICES and slices * (plan.tiles + 1) <= MAX_OFFSETS


def _round4(words: int) -> int:
    return -(-words // 4) * 4


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

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    of the path ``bank_scatter_path`` picks from the shape.
    """
    if all(t.device.type == "cpu" for t in (registers, keys, idx, rank)):
        return bank_scatter_max_plain(registers, keys, idx, rank)
    flat = _check(registers, keys, idx, rank)
    if _build.on_meta(registers, *flat):
        costs.kernel("bank_scatter_max", *_cost(registers, flat[0].numel()))
        return torch.empty_like(registers)
    device = _build.require_cuda(registers, *flat)
    rows, m = registers.shape
    if bank_scatter_path(rows, m, flat[0].numel(), _build.sm_count(device)) == "global":
        return _global(registers, *flat, device)
    return _tiled(registers, *flat, device)


def bank_scatter_max_tiled(
    registers: torch.Tensor, keys: torch.Tensor, idx: torch.Tensor, rank: torch.Tensor
) -> torch.Tensor:
    """``bank_scatter_max`` on its tiled path; raises ValueError where the
    plan or the stream is past its limits.  ``bank_scatter_max`` takes it
    where ``bank_scatter_path`` says so; called directly, it times this
    path at any shape the limits allow.  A CPU tensor runs the plain
    version.
    """
    if all(t.device.type == "cpu" for t in (registers, keys, idx, rank)):
        return bank_scatter_max_plain(registers, keys, idx, rank)
    flat = _check(registers, keys, idx, rank)
    return _tiled(registers, *flat, _build.require_cuda(registers, *flat))


def _cost(registers: torch.Tensor, n: int):
    """The bank read and written once, 12 B an entry of the stream."""
    return 0, 2 * registers.numel() + 12 * n


def _tiled(registers, keys, idx, rank, device) -> torch.Tensor:
    rows, m = registers.shape
    n = keys.numel()
    registers = registers.contiguous()
    if n == 0 or rows == 0:
        return registers.clone()
    sms = _build.sm_count(device)
    if not tiled_fits(rows, m, n, sms):
        raise ValueError(f"a ({rows}, {m}) bank at {n} entries is past the tiled path's limits")
    plan = bank_tile_plan(rows, m)
    per, slices = stream_split(n, sms)
    if registers.data_ptr() % 16:  # a view into a larger tensor may start off a 16-byte boundary
        registers = registers.clone()
    # every register of `out` is written by the tile pass
    out = torch.empty_like(registers)
    # one scratch (the launcher lays it out): per-slice tile offsets,
    # per-tile totals, unit starts and the split tiles, then from 16-byte
    # boundaries the packed entries and the extra units' partial tiles
    packed_at = _round4(slices * (plan.tiles + 1) + 3 * plan.tiles + 2)
    words = _round4(packed_at + per * slices) + (n // UNIT_ITEMS) * (TILE_BYTES // 4)
    scratch = torch.empty(words, dtype=torch.int32, device=device)
    _build.launch("bank_scatter_max", "bank_scatter", "bank_scatter_tiled_launch", _TILED_ARGTYPES, device,
                  (registers.data_ptr(), out.data_ptr(), keys.data_ptr(), idx.data_ptr(), rank.data_ptr(), n, rows,
                   m, plan.rows_per_tile, plan.tiles, per, slices, UNIT_ITEMS, sms, scratch.data_ptr(), words),
                  *_cost(registers, n))
    return out


def bank_scatter_max_global(
    registers: torch.Tensor, keys: torch.Tensor, idx: torch.Tensor, rank: torch.Tensor
) -> torch.Tensor:
    """``bank_scatter_max`` on its global path, at any shape: one thread an
    entry raises its cell of a copy of the bank with a byte compare-and-swap
    (the design before the tiled one).  ``bank_scatter_max`` takes it where
    ``bank_scatter_path`` says so; called directly, it holds that path
    against the plain version and times it.  A CPU tensor runs the plain
    version.
    """
    if all(t.device.type == "cpu" for t in (registers, keys, idx, rank)):
        return bank_scatter_max_plain(registers, keys, idx, rank)
    flat = _check(registers, keys, idx, rank)
    return _global(registers, *flat, _build.require_cuda(registers, *flat))


def _global(registers, keys, idx, rank, device) -> torch.Tensor:
    rows, m = registers.shape
    out = registers.clone(memory_format=torch.contiguous_format)
    if keys.numel() == 0:
        return out
    _build.launch("bank_scatter_max", "bank_scatter", "bank_scatter_launch", _ARGTYPES, device,
                  (out.data_ptr(), keys.data_ptr(), idx.data_ptr(), rank.data_ptr(), keys.numel(), rows, m),
                  *_cost(registers, keys.numel()))
    return out
