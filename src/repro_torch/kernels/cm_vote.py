"""cm_vote: a count-min tick's batch-canonical Topkapi vote, with no sort.

The reference has no Pallas kernel for it: ``repro/sketch/countmin.py``'s
``_label_update`` votes in plain JAX, a ``lexsort`` of (value, cell), run
lengths and two ``segment_max``.  The port's plain version is
``sketch/countmin.py``'s ``_label_update`` (one ``torch.sort`` of 4n int64
keys, ``unique_consecutive``, ``bincount``, two ``scatter_reduce`` amax and
the absorb rule); ``cm_vote`` runs it for CPU tensors, and it is what the
tests hold the kernel to.  For CUDA tensors ``cm_vote`` launches
``csrc/cm_vote.cu``: three launches, no read to the host.

The kernel elects each cell's winner from the cell's own bucket of hits,
the counting sort's way: ``vote_plan`` cuts the bank into tiles of whole
(d, w) rows (a power of two of them), whose per-cell counts fit a block's
shared memory where the tile has at most ``TILE_CELLS`` cells (else they go
to a global scratch) and whose buckets fit it too where its hits fit
``SHARED_HITS`` (else, as for a hot row under skewed keys, the buckets go
to the card's memory), and the stream into slices of ``per`` entries; a
block per slice sorts its entries by tile, a block per tile counts its hits
per cell, scans, places each hit's item in its cell's bucket and elects
every cell of at most ``THREAD_HITS`` hits with one thread.  The longer
cells go on two lists that a third launch works through, a warp a cell up
to ``WARP_HITS`` hits and a block a cell beyond, each with a shared table
of (value, count) slots, the block's in passes past half of
``BLOCK_SLOTS`` distinct values: cells that skewed items or a hot row
fill, few on uniform traffic.  The path a cell takes is
chosen on the card from its count; ``cm_vote.cooperative`` keeps the last
call's counts of those cells, (warp cells, block cells) on the card, for
tests and ``chip_smoke.py`` to read.

What bounds it on the H100: memory, the (key, item) stream read once and
the label and vote tables read and written once, at 3.35 TB/s; the packed
slices and the buckets are written and read once more, mostly in L2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.obs import costs
from repro_torch.obs import metrics as obs_metrics

THREADS = 512  # a block's threads (csrc/cm_vote.cu's kThreads)
TILE_CELLS = 1 << 12  # a tile's cell counts a block holds in shared memory (16 KiB)
SHARED_HITS = 20480  # a tile's buckets a block holds in shared memory (80 KiB; kSharedHits)
HIST_TILES = 1 << 14  # tiles a slice's shared histogram holds; a larger bank takes larger tiles
# entries a slice stages in shared memory (64 KiB): 4 B an entry where a tile
# is one row (its item), else 8 B (the row in the tile too), so half as many
MIN_SLICE, MAX_SLICE = 1 << 10, 1 << 14
THREAD_HITS = 16  # a cell of at most this many hits is elected by one thread (kThreadHits)
WARP_HITS = 256  # ... of at most this many by a warp, beyond it by a block (kWarpHits)
BLOCK_SLOTS = 1 << 13  # a block's (value, count) table (kBlockSlots); past half of it, passes
BLOCKS_PER_SM = 2  # blocks of the cooperative launch (96 KiB of shared memory each)
LIST_BYTES = 16  # a listed cell: its bucket's start (int64), its cell and its hits (int32)
HEAD_WORDS = 8  # the card's counters, int64 (kHeadWords)

_ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong]
    + [ctypes.c_int] * 7
    + [ctypes.c_void_p] * 8
)


@dataclasses.dataclass(frozen=True)
class VotePlan:
    """How the kernel cuts a (B, d, w) bank and an n-entry stream: tiles of
    ``rows_per_tile`` whole rows (a power of two; the last tile fewer),
    counted in shared memory where ``shared``; slices of ``per`` entries (a
    multiple of 4)."""

    rows: int
    cells: int
    rows_per_tile: int
    tiles: int
    shared: bool
    per: int
    slices: int

    @property
    def tile_shift(self) -> int:
        return self.rows_per_tile.bit_length() - 1


def vote_plan(rows: int, depth: int, width: int, n: int, sms: int) -> VotePlan:
    """The plan of an n-entry vote into a ``rows`` x (depth, width) bank on a
    card of ``sms`` SMs: the most rows a tile (a power of two) whose counts
    fit TILE_CELLS and whose hits, were the keys uniform, would fill at most
    half of SHARED_HITS; at least one, and at most HIST_TILES tiles; slices
    of MIN_SLICE to MAX_SLICE entries (half that where a tile holds several
    rows), two an SM where that many fit."""
    cells = depth * width
    fit = min(TILE_CELLS // cells, SHARED_HITS * rows // (2 * n * depth) if n else TILE_CELLS)
    per_tile = 1 << max(0, fit.bit_length() - 1)
    while -(-rows // per_tile) > HIST_TILES:
        per_tile *= 2
    per = min(MAX_SLICE if per_tile == 1 else MAX_SLICE // 2, max(MIN_SLICE, -(-n // (2 * sms))))
    per = -(-per // 4) * 4
    return VotePlan(rows, cells, per_tile, -(-rows // per_tile), per_tile * cells <= TILE_CELLS, per,
                    -(-n // per))


def _align(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def vote_layout(plan: VotePlan, n: int, depth: int) -> dict:
    """{region: (byte offset, bytes)} of the scratch the launcher is given,
    each region from a 16-byte boundary: the slices' tile offsets, the packed
    slices, the buckets, the two lists (a cell on them has more than
    THREAD_HITS or WARP_HITS hits, so n * d bounds their lengths) and, where
    the tiles' counts do not fit shared memory, the global counts."""
    hits = n * depth
    sizes = {
        "offsets": 4 * plan.slices * (plan.tiles + 1),
        "packed": (4 if plan.rows_per_tile == 1 else 8) * plan.per * plan.slices,
        "bucket": 4 * hits,
        "warp_list": LIST_BYTES * (hits // (THREAD_HITS + 1) + 1),
        "block_list": LIST_BYTES * (hits // (WARP_HITS + 1) + 1),
        "global_counts": 0 if plan.shared else 4 * plan.rows * plan.cells,
    }
    layout, at = {}, 0
    for name, size in sizes.items():
        layout[name] = (at, size)
        at += _align(size)
    return layout


def _check(labels: torch.Tensor, label_counts: torch.Tensor, keys: torch.Tensor, items: torch.Tensor, cfg):
    shape = (labels.shape[0], cfg.depth, cfg.width) if labels.dim() == 3 else None
    for name, t in (("labels", labels), ("label_counts", label_counts)):
        if t.dim() != 3 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be (B, {cfg.depth}, {cfg.width}), got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if labels.shape[0] * cfg.cells >= 1 << 31:
        raise ValueError(
            f"cm cell space B*d*w = {labels.shape[0]}*{cfg.depth}*{cfg.width} overflows int32 segment ids; "
            f"split the fleet across multiple banks or shards"
        )
    if keys.dim() != 1 or not keys.is_contiguous():
        keys = keys.reshape(-1).contiguous()
    if items.dtype == torch.uint32:
        items = items.view(torch.int32)
    if items.dim() != 1 or not items.is_contiguous():
        items = items.reshape(-1).contiguous()
    if keys.dtype != torch.int32 or items.dtype != torch.int32:
        raise TypeError(f"keys and items must be int32, got {keys.dtype} and {items.dtype}")
    if keys.numel() != items.numel():
        raise ValueError(f"keys ({keys.numel()}) and items ({items.numel()}) differ in length")
    return keys, items


def cm_vote(
    labels: torch.Tensor, label_counts: torch.Tensor, keys: torch.Tensor, items: torch.Tensor, cfg
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch-canonical Topkapi vote of a keyed (key, item) int32 stream
    into (B, d, w) int32 label and vote tables -> new tables (the inputs are
    never written); keys outside [0, B) vote nowhere.

    A CPU tensor runs the plain version (``sketch.countmin._label_update``);
    a CUDA tensor launches the kernel, counted in ``cm.vote.shared`` or
    ``cm.vote.global`` (where the tiles' counts live); ``meta`` tensors
    return empty tables and declare the kernel's cost.
    """
    if all(t.device.type == "cpu" for t in (labels, label_counts, keys, items)):
        from repro_torch.sketch.countmin import _label_update

        return _label_update(labels, label_counts, keys, items, cfg)
    keys, items = _check(labels, label_counts, keys, items, cfg)
    rows, n = labels.shape[0], keys.numel()
    if _build.on_meta(labels, label_counts, keys, items):
        costs.kernel("cm_vote", *_cost(rows * cfg.cells, n))
        return torch.empty_like(labels), torch.empty_like(label_counts)
    device = _build.require_cuda(labels, label_counts, keys, items)
    if n == 0 or rows == 0:
        return labels.clone(memory_format=torch.contiguous_format), label_counts.clone(
            memory_format=torch.contiguous_format)
    if n >= 1 << 31 or n * cfg.depth >= 1 << 32:
        raise ValueError(f"a vote takes fewer than 2^31 entries and 2^32 hits, got {n} x depth {cfg.depth}")
    sms = _build.sm_count(device)
    args, regions, nbytes, path = _launch_args(rows, cfg.depth, cfg.width, cfg.seed, n, sms)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
    head = torch.empty(HEAD_WORDS, dtype=torch.int64, device=device)
    labels, label_counts = labels.contiguous(), label_counts.contiguous()
    out_l, out_c = torch.empty_like(labels), torch.empty_like(label_counts)
    base = scratch.data_ptr()
    _build.launch("cm_vote", "cm_vote", "cm_vote_launch", _ARGTYPES, device,
                  (labels.data_ptr(), label_counts.data_ptr(), out_l.data_ptr(), out_c.data_ptr(), keys.data_ptr(),
                   items.data_ptr(), *args, *(None if at is None else base + at for at in regions), head.data_ptr()),
                  *_cost(rows * cfg.cells, n))
    cm_vote.cooperative = head[1:3]
    obs_metrics.inc(path)
    return out_l, out_c


@functools.lru_cache(maxsize=64)
def _launch_args(rows: int, depth: int, width: int, seed: int, n: int, sms: int):
    """The launcher's plan arguments, the scratch regions' byte offsets
    (None for an empty one), the scratch's bytes and the path's counter
    name, for one shape: the same at every tick."""
    plan = vote_plan(rows, depth, width, n, sms)
    layout = vote_layout(plan, n, depth)
    log2_width = width.bit_length() - 1 if width & (width - 1) == 0 else -1
    args = (n, rows, depth, width, seed, log2_width, plan.tile_shift, plan.tiles, int(plan.shared), plan.per,
            plan.slices, BLOCKS_PER_SM * sms)
    regions = tuple(at if size else None for at, size in layout.values())
    nbytes = max(at + _align(size) for at, size in layout.values())
    return args, regions, nbytes, "cm.vote.shared" if plan.shared else "cm.vote.global"


def _cost(cells: int, n: int):
    """8 B a (key, item) pair read once, the two tables read and written once."""
    return 0, 8 * n + 16 * cells


cm_vote.cooperative = None
