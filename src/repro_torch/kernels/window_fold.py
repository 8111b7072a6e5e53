"""window_fold: bucket-wise max over the slices of a (W, B, m) uint8 ring.

Replaces the TPU kernels ``repro/kernels/window_fold.py::window_fold_max``
(``_window_kernel``, the masked ring fold of a sliding-window read,
DESIGN.md §11) and ``window_merge_max`` (the same fold with every slice
live, over the K fragments of the incremental read, DESIGN.md §14).  The
CUDA source is ``csrc/window_fold.cu``; the two wrappers launch its two
entry points, counted apart.

The TPU kernels tile the ring over row blocks of at most 4096 int32 cells
(p <= 12) and the wrapper upcasts the uint8 ring to int32 for them.  Here
the ring stays uint8: each thread owns 16 bytes of the (B * m) plane,
walks the W slices with one 16-byte load each and folds with the per-byte
max ``__vmaxu4``.  The (W,) mask lies on the card and is read there, so a
read costs no device-to-host copy; dead slices are skipped unread.  What
bounds it on the H100: memory, the live slices' bytes read once and B*m
bytes written, at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.obs import costs
from repro_torch.sketch import hll

_FOLD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p,
]
_MERGE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
]


def _check_ring(ring: torch.Tensor, what: str) -> torch.Tensor:
    if ring.dim() != 3 or ring.shape[0] < 1:
        raise ValueError(f"{what} must be (W >= 1, B, m), got {tuple(ring.shape)}")
    if ring.dtype != hll.REGISTER_DTYPE:
        raise TypeError(f"{what} must be uint8 registers, got {ring.dtype}")
    if (ring.shape[1] * ring.shape[2]) % 16:
        raise ValueError(f"the kernel folds 16-byte vectors; B*m must divide by 16, got {tuple(ring.shape)}")
    return ring.contiguous()


def _check_mask(mask: torch.Tensor, window: int) -> torch.Tensor:
    if mask.shape != (window,):
        raise ValueError(f"mask must be ({window},), got {tuple(mask.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
    return mask.contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # a view into a larger tensor may start off a 16-byte boundary
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _cost(stack: torch.Tensor):
    """The (W, B, m) stack in, one (B, m) fold out."""
    return 0, stack.numel() + stack.numel() // stack.shape[0]


def window_fold_max_plain(ring: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: dead slices as zeros, max over the W axis."""
    ring = _check_ring(ring, "ring")
    mask = _check_mask(mask, ring.shape[0])
    return torch.amax(torch.where(mask.bool()[:, None, None], ring, 0), dim=0)


def window_fold_max(ring: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fold a (W, B, m) uint8 ring into (B, m) over the slices ``mask`` marks live.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if ring.device.type == "cpu" and mask.device.type == "cpu":
        return window_fold_max_plain(ring, mask)
    if _build.on_meta(ring, mask):
        ring = _check_ring(ring, "ring")
        _check_mask(mask, ring.shape[0])
        costs.kernel("window_fold_max", *_cost(ring))
        return torch.empty(ring.shape[1:], dtype=ring.dtype, device="meta")
    ring = _aligned(_check_ring(ring, "ring"))
    mask = _check_mask(mask, ring.shape[0])
    device = _build.require_cuda(ring, mask)
    window, rows, m = ring.shape
    out = torch.empty((rows, m), dtype=ring.dtype, device=device)
    _build.launch("window_fold_max", "window_fold", "window_fold_launch", _FOLD_ARGTYPES, device,
                  (ring.data_ptr(), mask.data_ptr(), window, rows * m, out.data_ptr()), *_cost(ring))
    return out


def window_merge_max_plain(parts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: max over the K axis."""
    return torch.amax(_check_ring(parts, "parts"), dim=0)


def window_merge_max(parts: torch.Tensor) -> torch.Tensor:
    """Fold a (K, B, m) uint8 stack of fold fragments into (B, m) by max.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if parts.device.type == "cpu":
        return window_merge_max_plain(parts)
    if _build.on_meta(parts):
        parts = _check_ring(parts, "parts")
        costs.kernel("window_merge_max", *_cost(parts))
        return torch.empty(parts.shape[1:], dtype=parts.dtype, device="meta")
    parts = _aligned(_check_ring(parts, "parts"))
    device = _build.require_cuda(parts)
    k, rows, m = parts.shape
    out = torch.empty((rows, m), dtype=parts.dtype, device=device)
    _build.launch("window_merge_max", "window_fold", "window_merge_launch", _MERGE_ARGTYPES, device,
                  (parts.data_ptr(), k, rows * m, out.data_ptr()), *_cost(parts))
    return out
