"""bucket_fold: element-wise max of k pipeline partials, (k, m) -> (m,).

Replaces the TPU kernel ``repro/kernels/bucket_fold.py::bucket_fold``
(``_fold_kernel``), the paper's "Merge buckets" module.  The CUDA source is
``csrc/bucket_fold.cu``.

What bounds it on the H100: memory, k*m register bytes read and m written
(3.35 TB/s); at the main path's (8, 65536) uint8 that is 0.18 us, far
under a launch, so the launch dominates.  Its design: one thread per
column of 16 bytes (4 bytes where rows do not start on 16-byte
boundaries), walking the k rows with 8 rows' loads in flight at once,
coalesced along m; uint8 registers fold four to a word with the per-byte
max ``__vmaxu4``, int32 partials with max; blocks small enough that the
grid spreads over every SM.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.obs import costs

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_ELEMENT_BYTES = {torch.uint8: 1, torch.int32: 4}


def _check(partials: torch.Tensor) -> torch.Tensor:
    if partials.dim() != 2 or partials.shape[0] < 1:
        raise ValueError(f"partials must be (k >= 1, m), got {tuple(partials.shape)}")
    if partials.dtype not in _ELEMENT_BYTES:
        raise TypeError(f"partials must be uint8 or int32, got {partials.dtype}")
    if partials.dtype == torch.uint8 and partials.shape[1] % 4:
        raise ValueError(f"uint8 partials need m divisible by 4, got m={partials.shape[1]}")
    return partials.contiguous()


def bucket_fold_plain(partials: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: max over the pipeline axis."""
    return torch.amax(_check(partials), dim=0)


def bucket_fold(partials: torch.Tensor) -> torch.Tensor:
    """Fold (k, m) uint8 or int32 partial registers into (m,) by max.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if partials.device.type == "cpu":
        return bucket_fold_plain(partials)
    partials = _check(partials)
    k, m = partials.shape
    cost = 0, (k + 1) * m * _ELEMENT_BYTES[partials.dtype]  # the partials in, the fold out
    if _build.on_meta(partials):
        costs.kernel("bucket_fold", *cost)
        return torch.empty((m,), dtype=partials.dtype, device="meta")
    device = _build.require_cuda(partials)
    out = torch.empty((m,), dtype=partials.dtype, device=device)
    _build.launch("bucket_fold", "bucket_fold", "bucket_fold_launch", _ARGTYPES, device,
                  (partials.data_ptr(), out.data_ptr(), k, m, _ELEMENT_BYTES[partials.dtype], _build.sm_count(device)),
                  *cost)
    return out
