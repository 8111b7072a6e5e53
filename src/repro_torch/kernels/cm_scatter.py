"""cm_scatter: count-min ingest and ring fold, mod 2^32.

Replaces the TPU kernels ``repro/kernels/cm_scatter.py::cm_scatter_add``
(``_cm_kernel``, the keyed d-hit scatter-add of a ``CountMinBank`` ingest,
DESIGN.md §13) and ``cm_window_fold_sum`` (``_cm_fold_kernel``, the masked
ring sum of a ``WindowedCountMinBank`` read).  The CUDA source is
``csrc/cm_scatter.cu``; the two wrappers launch its two entry points,
counted apart.

Counters are uint32 in the reference; here they are int32 tensors holding
the uint32 bits, because PyTorch has almost no ``torch.uint32`` arithmetic.
Two's-complement int32 adds are the same bits as uint32 adds mod 2^32.

The TPU kernel takes a d-expanded (key, cell, hit) stream tiled to
(rows, 128) and sums it with a one-hot compare-reduce into row blocks of at
most 4096 cells (``MAX_BLOCK_CELLS``), because the TPU has no
read-modify-write port.  Here ``cm_scatter_add`` takes the raw (key, item)
stream and keeps the hot counters on chip, as ``sparse_scatter`` keeps its
cells: ``cm_tile_plan`` cuts the bank into tiles of whole (d, w) rows (a
power of two of them, at most 2^14 counters, 64 KB of shared memory); a
block per slice of the stream (``stream_split``) sorts its items by tile;
a block per work unit loads its tile's counters, lands its items' d hits
(murmur3_64, the same h1 as the HLL kernels, Kirsch-Mitzenmacher columns)
with shared atomics and writes the whole tile, so the bank copy folds into
the pass.  A tile with more items than ``UNIT_ITEMS`` is split into units
over groups of slices (ceil(items / UNIT_ITEMS), at most one a slice); its
extra units add their partials with global atomics after the first unit
has written the tile.  The plan's limits live here, and the launcher checks
only that a plan is consistent.  A row larger than a tile, or a plan or
stream past those limits, takes the global path (``cm_scatter_path``,
``cm_scatter_add_global``), the previous design: one thread per item, d
global ``atomicAdd`` hits into a copy of the bank.  What bounds it
on the H100: memory, 8 B of stream per item plus the bank read and written
once, at 3.35 TB/s.  ``cm_window_fold_sum`` is
``window_fold``'s structure with + for max: 16 bytes of the (B * d * w)
plane per thread, the (W,) mask read on the card, dead slices skipped
unread; bound: the live slices read once and the plane written once.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparse_scatter import MAX_SLICES, stream_split
from repro_torch.obs import costs
from repro_torch.sketch.countmin import CMConfig, cm_hash_index

COUNTER_DTYPE = torch.int32  # the uint32 counters' bits

TILE_CELLS = 1 << 14  # counters a tile holds in shared memory (64 KB)
HIST_TILES = 1 << 14  # tiles a shared histogram holds; more take the global path
UNIT_ITEMS = 1 << 13  # items a work unit takes; a tile with more is split
MAX_OFFSETS = 1 << 24  # entries of the (slices, tiles + 1) offsets scratch; more take the global path

_SCATTER_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_void_p]
)
_TILED_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_ulonglong]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
)
_FOLD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p,
]


def _check_cell_space(rows: int, cfg: CMConfig) -> None:
    """The reference's limit: flattened cell ids must fit int32 (B*d*w < 2^31)."""
    if rows * cfg.cells >= 1 << 31:
        raise ValueError(
            f"cm cell space B*d*w = {rows}*{cfg.depth}*{cfg.width} overflows int32 "
            f"segment ids; split the fleet across multiple banks or shards"
        )


@dataclasses.dataclass(frozen=True)
class CMTilePlan:
    """How the tiled kernel cuts a (B, d, w) bank: tiles of ``rows_per_tile``
    whole rows of ``cells = d * w`` counters (the last tile fewer), a power
    of two, so that a key's tile is a shift.
    ``log2_width``: log2(w) where w is a power of two (items pack into 32
    bits), else -1.  ``global_path``: a row larger than a tile, or more
    tiles than a shared histogram holds.
    """

    rows: int
    cells: int
    rows_per_tile: int
    tiles: int
    log2_width: int
    global_path: bool

    def rows_of(self, tile: int) -> Tuple[int, int]:
        """The row range [lo, hi) of ``tile``."""
        lo = tile * self.rows_per_tile
        return lo, min(self.rows, lo + self.rows_per_tile)


def cm_tile_plan(rows: int, cfg: CMConfig) -> CMTilePlan:
    """The tile plan of a ``rows`` x ``cfg`` bank."""
    cells = cfg.cells
    width = cfg.width
    log2_width = width.bit_length() - 1 if width & (width - 1) == 0 else -1
    if cells > TILE_CELLS:
        return CMTilePlan(rows, cells, 0, 0, log2_width, True)
    per = 1 << ((TILE_CELLS // cells).bit_length() - 1)
    tiles = -(-rows // per)
    return CMTilePlan(rows, cells, per, tiles, log2_width, tiles > HIST_TILES)


def cm_scatter_path(rows: int, cfg: CMConfig, n: int, sms: int) -> str:
    """"tiled" or "global": the path ``cm_scatter_add`` takes for ``n`` items
    into a ``rows`` x ``cfg`` bank on a card of ``sms`` SMs."""
    plan = cm_tile_plan(rows, cfg)
    _, slices = stream_split(n, sms)
    if plan.global_path or slices > MAX_SLICES or slices * (plan.tiles + 1) > MAX_OFFSETS:
        return "global"
    return "tiled"


def _check_scatter(counters, keys, items, cfg: CMConfig):
    if counters.dim() != 3 or tuple(counters.shape[1:]) != (cfg.depth, cfg.width):
        raise ValueError(
            f"counters must be (B, {cfg.depth}, {cfg.width}), got {tuple(counters.shape)}"
        )
    if counters.dtype != COUNTER_DTYPE:
        raise TypeError(f"counters must be int32 (uint32 bits), got {counters.dtype}")
    _check_cell_space(counters.shape[0], cfg)
    keys = keys.reshape(-1).contiguous()
    items = items.reshape(-1)
    if items.dtype == torch.uint32:
        items = items.view(torch.int32)
    items = items.contiguous()
    if keys.dtype != torch.int32 or items.dtype != torch.int32:
        raise TypeError(f"keys and items must be int32, got {keys.dtype} and {items.dtype}")
    if keys.numel() != items.numel():
        raise ValueError(f"keys ({keys.numel()}) and items ({items.numel()}) differ in length")
    return keys, items


def cm_scatter_add_plain(
    counters: torch.Tensor, keys: torch.Tensor, items: torch.Tensor, cfg: CMConfig
) -> torch.Tensor:
    """The plain PyTorch version: ``cm_hash_index`` + one ``index_add_``.

    Item i of key b adds 1 at flat cell ``b*d*w + r*w + idx_r(i)`` of each
    depth row r; keys outside [0, B) route to a trailing cell that is cut
    off (never clamped into a neighbour).  int32 adds wrap as uint32 would.
    """
    keys, items = _check_scatter(counters, keys, items, cfg)
    rows, depth, width = counters.shape
    cells = depth * width
    idx = cm_hash_index(items, cfg).to(torch.int64)  # (d, n)
    valid = (keys >= 0) & (keys < rows)
    lane = torch.arange(depth, dtype=torch.int64, device=idx.device)[:, None] * width
    seg = torch.where(valid[None, :], keys[None, :].to(torch.int64) * cells + lane + idx, rows * cells)
    flat = torch.cat([counters.reshape(-1), counters.new_zeros(1)])
    flat.index_add_(0, seg.reshape(-1), torch.ones(seg.numel(), dtype=COUNTER_DTYPE, device=flat.device))
    return flat[: rows * cells].reshape(rows, depth, width)


def cm_scatter_add(
    counters: torch.Tensor, keys: torch.Tensor, items: torch.Tensor, cfg: CMConfig
) -> torch.Tensor:
    """Add a keyed (key, item) int32 stream into a copy of a (B, d, w) bank.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if all(t.device.type == "cpu" for t in (counters, keys, items)):
        return cm_scatter_add_plain(counters, keys, items, cfg)
    keys, items = _check_scatter(counters, keys, items, cfg)
    if _build.on_meta(counters, keys, items):
        costs.kernel("cm_scatter_add", *_cost(counters, keys.numel()))
        return torch.empty_like(counters)
    device = _build.require_cuda(counters, keys, items)
    counters = counters.contiguous()
    rows, n = counters.shape[0], keys.numel()
    if n == 0 or rows == 0:
        return counters.clone()
    sms = _build.sm_count(device)
    if cm_scatter_path(rows, cfg, n, sms) == "global":
        return cm_scatter_add_global(counters, keys, items, cfg)
    # every counter of `out` is written by the tile pass
    plan = cm_tile_plan(rows, cfg)
    per, slices = stream_split(n, sms)
    out = torch.empty_like(counters)
    # one scratch (the launcher lays it out): per-slice tile offsets,
    # per-tile totals and unit starts, then the packed items, 32 or 64 bits
    # an item, from a 16-byte boundary
    head = slices * (plan.tiles + 1) + 2 * plan.tiles + 1
    words = -(-head // 4) * 4 + per * slices * (1 if plan.log2_width >= 0 else 2)
    scratch = torch.empty(words, dtype=torch.int32, device=device)
    _build.launch("cm_scatter_add", "cm_scatter", "cm_scatter_tiled_launch", _TILED_ARGTYPES, device,
                  (counters.data_ptr(), out.data_ptr(), keys.data_ptr(), items.data_ptr(), n, rows, cfg.depth,
                   cfg.width, cfg.seed, plan.rows_per_tile, plan.tiles, plan.log2_width, per, slices,
                   UNIT_ITEMS, scratch.data_ptr(), words),
                  *_cost(counters, n))
    return out


def _cost(counters: torch.Tensor, n: int):
    """The bank read and written once, 8 B a (key, item) pair."""
    return 0, 8 * n + 2 * 4 * counters.numel()


def cm_scatter_add_global(
    counters: torch.Tensor, keys: torch.Tensor, items: torch.Tensor, cfg: CMConfig
) -> torch.Tensor:
    """``cm_scatter_add`` on its global path, at any shape: one thread an
    item lands d global ``atomicAdd`` hits into a copy of the bank (the
    design before the tiled one).  ``cm_scatter_add`` takes it where the
    tiled plan does not fit; called directly, it holds that path against
    the plain version and times it at the main shape.  A CPU tensor runs the
    plain version.
    """
    if all(t.device.type == "cpu" for t in (counters, keys, items)):
        return cm_scatter_add_plain(counters, keys, items, cfg)
    keys, items = _check_scatter(counters, keys, items, cfg)
    device = _build.require_cuda(counters, keys, items)
    out = counters.contiguous().clone()
    n = keys.numel()
    if n == 0 or out.shape[0] == 0:
        return out
    _build.launch("cm_scatter_add", "cm_scatter", "cm_scatter_launch", _SCATTER_ARGTYPES, device,
                  (out.data_ptr(), keys.data_ptr(), items.data_ptr(), n, out.shape[0], cfg.depth, cfg.width, cfg.seed),
                  *_cost(out, n))
    return out


def _check_ring(ring: torch.Tensor, mask: torch.Tensor):
    if ring.dim() < 2 or ring.shape[0] < 1:
        raise ValueError(f"ring must be (W >= 1, B, ...), got {tuple(ring.shape)}")
    if ring.dtype != COUNTER_DTYPE:
        raise TypeError(f"ring must be int32 (uint32 bits), got {ring.dtype}")
    if mask.shape != (ring.shape[0],):
        raise ValueError(f"mask must be ({ring.shape[0]},), got {tuple(mask.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
    return ring.contiguous(), mask.contiguous()


def _fold_cost(ring: torch.Tensor):
    """The (W, B, ...) ring in, one (B, ...) fold out, 4 B a counter."""
    return 0, 4 * (ring.numel() + ring.numel() // ring.shape[0])


def cm_window_fold_sum_plain(ring: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: dead slices as zeros, an int32 sum over W."""
    ring, mask = _check_ring(ring, mask)
    live = mask.bool().reshape((-1,) + (1,) * (ring.dim() - 1))
    return torch.where(live, ring, 0).sum(0, dtype=COUNTER_DTYPE)


def cm_window_fold_sum(ring: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fold a (W, B, ...) int32 counter ring into (B, ...) by masked sum mod 2^32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if ring.device.type == "cpu" and mask.device.type == "cpu":
        return cm_window_fold_sum_plain(ring, mask)
    ring, mask = _check_ring(ring, mask)
    if _build.on_meta(ring, mask):
        costs.kernel("cm_window_fold_sum", *_fold_cost(ring))
        return torch.empty(ring.shape[1:], dtype=ring.dtype, device="meta")
    if ring.data_ptr() % 16:  # a view into a larger tensor may start off a 16-byte boundary
        ring = ring.clone()
    device = _build.require_cuda(ring, mask)
    window = ring.shape[0]
    out = torch.empty(ring.shape[1:], dtype=ring.dtype, device=device)
    _build.launch("cm_window_fold_sum", "cm_scatter", "cm_fold_launch", _FOLD_ARGTYPES, device,
                  (ring.data_ptr(), mask.data_ptr(), window, out.numel(), out.data_ptr()), *_fold_cost(ring))
    return out
