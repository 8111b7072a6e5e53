"""hll_estimate: a uint8 register bank's histogram, or its "original" estimates, in one pass.

The reference has no Pallas kernel here: it histograms a (possibly batched)
bank with ``jnp.bincount`` (``repro/sketch/estimators.py``,
``register_histogram``) and finalizes the "original" estimator in plain JAX
(``_original_device``).  The port's plain versions are those two functions
of ``sketch/estimators.py`` (``register_histogram_plain``: a ``bincount``
of offset registers, which reads its input's min and max back to the host;
``_original_device``: an ``addmv`` and a few elementwise passes); the
estimators run them wherever ``kernel_takes`` says no (CPU tensors, other
register dtypes), and the tests hold the kernel to them.  For a uint8 bank
on the card the wrapper launches ``csrc/hll_estimate.cu`` once, with no
read to the host: each row's registers are counted by a group of
threads with shared atomics into a sub-histogram for each of the row's
warps, summed, and either written as (..., K) int32 counts or finalized
there into the "original" estimate (the harmonic sum in float64, rounded
once to float32, then ``_original_device``'s float32 steps).
The estimator's name picks the mode: the kernel finalizes the estimators
of ``FINALIZED`` ("original") and gives every other estimator its counts.

What bounds it on the H100: the bank read once and the output written
once, at 3.35 TB/s (the 1024-row p = 12 fleet bank, 4 MiB: 1.25 us, under
the launch's own time).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.obs import costs
from repro_torch.sketch.hll import HLLConfig, alpha

FINALIZED = ("original",)  # the estimators whose estimates the kernel writes itself
MODES = ("histogram",) + FINALIZED  # what the kernel writes: the (..., K) counts, or those estimates
BLOCK_THREADS = 256  # a block's threads where rows share it
ROW_THREADS = 512  # a row's threads at most (csrc/hll_estimate.cu's kMaxThreads): 8 loads a thread at m = 2^16
BLOCK_ROWS = 32  # rows a block at most: their counts stay in shared memory

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def kernel_takes(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether registers of ``dtype`` on ``device`` go to the kernel: uint8
    (``hll.REGISTER_DTYPE``) on the card, or on ``meta`` for the op
    analysis; any other dtype, and the CPU, keep the plain versions."""
    return device.type in ("cuda", "meta") and dtype == torch.uint8


def estimate_plan(m: int) -> Tuple[int, int]:
    """(group, rows): a row of m registers is read by ``group`` threads, 16
    bytes a load, and a block of group * rows threads takes ``rows`` rows:
    one block a row from m = 4096 up (m = 65536: 512 threads, 8 loads
    each), BLOCK_THREADS threads and up to BLOCK_ROWS rows a block below."""
    group = min(m // 16, ROW_THREADS)
    return group, max(1, min(BLOCK_ROWS, BLOCK_THREADS // group))


def hll_estimate(registers: torch.Tensor, cfg: HLLConfig, mode: str) -> torch.Tensor:
    """(..., m) uint8 registers -> (..., K) int32 counts (``mode``
    "histogram") or (...,) float32 "original" estimates; register values
    past max_rank count nowhere, never in a neighbouring row.

    A CUDA tensor launches the kernel once (a bank off a 16-byte boundary
    is copied to an aligned one first); a ``meta`` tensor gives an empty
    output and declares the cost.  The plain versions are the estimators'
    (``kernel_takes``).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if registers.shape[-1:] != (cfg.m,):
        raise ValueError(f"expected a (..., {cfg.m}) register bank, got {tuple(registers.shape)}")
    if registers.dtype != torch.uint8:
        raise TypeError(f"the kernel takes uint8 registers, got {registers.dtype}")
    batch = tuple(registers.shape[:-1])
    rows, k = registers.numel() // cfg.m, cfg.max_rank + 1
    out = torch.empty(batch + ((k,) if mode == "histogram" else ()),
                      dtype=torch.int32 if mode == "histogram" else torch.float32, device=registers.device)
    if _build.on_meta(registers):
        costs.kernel("hll_estimate", *_cost(rows, cfg, mode))
        return out
    device = _build.require_cuda(registers)
    if rows == 0:
        return out
    group, per_block = estimate_plan(cfg.m)
    regs = registers.contiguous()
    if regs.data_ptr() % 16:  # the kernel's 16-byte loads; no caller's bank lies off a boundary
        regs = regs.clone()
    _build.launch("hll_estimate", "hll_estimate", "hll_estimate_launch", _ARGTYPES, device,
                  (regs.data_ptr(), rows, cfg.m, k, group, per_block, int(mode == "original"),
                   alpha(cfg.m) * cfg.m * cfg.m, cfg.hash_bits, out.data_ptr()),
                  *_cost(rows, cfg, mode))
    return out


def _cost(rows: int, cfg: HLLConfig, mode: str):
    """Each register read once and the output written once; "original"
    adds the harmonic sum's K multiply-adds a row."""
    k = cfg.max_rank + 1
    if mode == "histogram":
        return 0, rows * cfg.m + 4 * rows * k
    return 2 * k * rows, rows * cfg.m + 4 * rows
