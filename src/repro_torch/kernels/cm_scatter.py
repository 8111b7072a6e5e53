"""cm_scatter: count-min ingest and ring fold, mod 2^32.

Replaces the TPU kernels ``repro/kernels/cm_scatter.py::cm_scatter_add``
(``_cm_kernel``, the keyed d-hit scatter-add of a ``CountMinBank`` ingest,
DESIGN.md §13) and ``cm_window_fold_sum`` (``_cm_fold_kernel``, the masked
ring sum of a ``WindowedCountMinBank`` read).  The CUDA source is
``csrc/cm_scatter.cu``; the two wrappers launch its two entry points and
count their launches apart.

Counters are uint32 in the reference; here they are int32 tensors holding
the uint32 bits, because PyTorch has almost no ``torch.uint32`` arithmetic.
Two's-complement int32 adds are the same bits as uint32 adds mod 2^32.

The TPU kernel takes a d-expanded (key, cell, hit) stream tiled to
(rows, 128) and sums it with a one-hot compare-reduce into row blocks of at
most 4096 cells (``MAX_BLOCK_CELLS``), because the TPU has no
read-modify-write port.  Here ``cm_scatter_add`` takes the raw (key, item)
stream: one thread per item hashes it (murmur3_64, the same h1 as the HLL
kernels), picks its d Kirsch-Mitzenmacher columns and lands d ``atomicAdd``
hits into a copy of the whole (B, d, w) bank.  What bounds it on the H100:
memory, 8 B of stream per item plus the bank copied once (read and
written), at 3.35 TB/s.  ``cm_window_fold_sum`` is ``window_fold``'s
structure with + for max: 16 bytes of the (B * d * w) plane per thread,
the (W,) mask read on the card, dead slices skipped unread; bound: the
live slices read once and the plane written once.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.sketch.countmin import CMConfig, cm_hash_index

COUNTER_DTYPE = torch.int32  # the uint32 counters' bits

_SCATTER_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_void_p]
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
    device = _build.require_cuda(counters, keys, items)
    out = counters.clone(memory_format=torch.contiguous_format)
    if keys.numel() == 0:
        return out
    fn = _build.function("cm_scatter", "cm_scatter_launch", _SCATTER_ARGTYPES)
    with torch.cuda.device(device):
        err = fn(
            out.data_ptr(), keys.data_ptr(), items.data_ptr(), keys.numel(), out.shape[0],
            cfg.depth, cfg.width, cfg.seed, _build.stream(device),
        )
    _build.check("cm_scatter", err, "cm_scatter_add")
    cm_scatter_add.launches += 1
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
    if ring.data_ptr() % 16:  # a view into a larger tensor may start off a 16-byte boundary
        ring = ring.clone()
    device = _build.require_cuda(ring, mask)
    window = ring.shape[0]
    out = torch.empty(ring.shape[1:], dtype=ring.dtype, device=device)
    fn = _build.function("cm_scatter", "cm_fold_launch", _FOLD_ARGTYPES)
    with torch.cuda.device(device):
        err = fn(ring.data_ptr(), mask.data_ptr(), window, out.numel(), out.data_ptr(),
                 _build.stream(device))
    _build.check("cm_scatter", err, "cm_window_fold_sum")
    cm_window_fold_sum.launches += 1
    return out


cm_scatter_add.launches = 0
cm_window_fold_sum.launches = 0
