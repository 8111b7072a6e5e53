"""hll_fused: hash, rank and register max of a whole stream.

Replaces the TPU kernel ``repro/kernels/hll_fused.py::hll_update_fused``
(``_fused_kernel``).  The CUDA source is ``csrc/hll_fused.cu``.

The TPU kernel merges items by a one-hot compare-reduce over all m buckets
(the TPU has no read-modify-write port) and so caps p at 12
(``MAX_FUSED_P``).  On Hopper the kernel runs two passes under one entry
point: G blocks of 1024 threads (``hll_partials``: two an SM, fewer for a
short stream) each keep a private uint8 register file in shared
memory (m bytes, 64 KiB at p = 16), raise registers with a
compare-and-swap on the containing 32-bit word (CUDA has no 8-bit
atomicMax) and store the file to a (G, m) scratch; then a column max over
the G files and the input registers writes the result once.  No global
atomic runs.  That covers p in [4, 16] and both hash widths.

What bounds it on the H100: the 4 B per item of the stream (3.35 TB/s), or
the tens of integer instructions of the 64-bit hash per item, whichever is
larger; the files cross the L2 once each way.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hash_rank import _check_items
from repro_torch.obs import costs
from repro_torch.sketch import hll
from repro_torch.sketch.hll import HLLConfig

FILE_THREADS = 1024  # threads of a block that keeps a register file
FILES_PER_SM = 2  # blocks an SM runs at once (2048 threads; 2 * 64 KiB of shared memory at p = 16)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]


def hll_partials(n: int, p: int, sms: int) -> int:
    """G, the private register files (blocks) for ``n`` items at precision
    ``p`` on a card of ``sms`` SMs: ``FILES_PER_SM`` an SM, fewer where a
    file would see fewer than max(FILE_THREADS, m / 16) items, since every
    file costs m bytes zeroed, stored and read back whatever its items."""
    per_file = max(FILE_THREADS, (1 << p) // 16)
    return max(1, min(FILES_PER_SM * sms, -(-n // per_file)))


def _cost(n: int, cfg: HLLConfig):
    """The stream read once and the registers read and written once."""
    return 0, 4 * n + 2 * cfg.m


def _check(registers: torch.Tensor, items: torch.Tensor, n_valid: Optional[int], cfg: HLLConfig):
    if registers.shape != (cfg.m,) or registers.dtype != hll.REGISTER_DTYPE:
        raise ValueError(
            f"registers must be ({cfg.m},) uint8, got {tuple(registers.shape)} {registers.dtype}"
        )
    items = _check_items(items)
    n = items.numel() if n_valid is None else max(0, min(int(n_valid), items.numel()))
    return items, n


def hll_update_fused_plain(
    registers: torch.Tensor, items: torch.Tensor, n_valid: Optional[int], cfg: HLLConfig
) -> torch.Tensor:
    """The plain PyTorch version: ``hll.update`` over the first n_valid items."""
    items, n = _check(registers, items, n_valid, cfg)
    return hll.update(registers, items[:n], cfg)


def hll_update_fused(
    registers: torch.Tensor,
    items: torch.Tensor,
    n_valid: Optional[int],
    cfg: HLLConfig,
) -> torch.Tensor:
    """Aggregate a flat stream into a copy of (m,) uint8 registers.

    Items at positions >= ``n_valid`` (None: every item) are no-ops.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if registers.device.type == "cpu" and items.device.type == "cpu":
        return hll_update_fused_plain(registers, items, n_valid, cfg)
    items, n = _check(registers, items, n_valid, cfg)
    if _build.on_meta(registers, items):
        costs.kernel("hll_update_fused", *_cost(n, cfg))
        return torch.empty_like(registers)
    device = _build.require_cuda(registers, items)
    registers = registers.contiguous()
    if registers.data_ptr() % 16:  # a view into a larger tensor may start off a 16-byte boundary
        registers = registers.clone()
    if n == 0:
        return registers.clone()
    files = hll_partials(n, cfg.p, _build.sm_count(device))
    scratch = torch.empty((files, cfg.m), dtype=hll.REGISTER_DTYPE, device=device)
    out = torch.empty_like(registers)
    _build.launch("hll_update_fused", "hll_fused", "hll_fused_launch", _ARGTYPES, device,
                  (out.data_ptr(), registers.data_ptr(), items.data_ptr(), n, cfg.p, cfg.hash_bits, cfg.seed,
                   scratch.data_ptr(), files),
                  *_cost(n, cfg))
    return out
