"""bank_count: the exact per-row counters of a keyed tick, in one pass.

The reference counts a tick's keys with ``jnp.bincount``
(``repro/sketch/bank.py``, ``update_many``) and adds the counts to each
row's (hi, lo) uint32 limbs; it has no Pallas kernel here.  The CUDA source
is ``csrc/bank_count.cu``: one pass reads every key once and writes the new
(B, 2) int64 limbs, with no read to the host.

``bank_count_path`` picks the path by shape: a shared uint32 histogram a
block, flushed into a uint64 scratch by 64-bit atomics, where ``rows`` bins
fit a block's shared memory with room for several blocks an SM; else a
shared table of TALLY_SLOTS (key, count) slots a block, which holds the hot
keys, with the keys it cannot place added straight into the scratch.  A
second launch adds the scratch into the limbs, after a memset of the
scratch: three launches in all.  The plain version (``bincount``, then
``u64.add``) is the CPU path and what the tests hold the kernel to.  Drop
rule (DESIGN.md §9): keys outside [0, B) count nowhere.  What bounds it on
the H100: 4 B a key read once and 16 B a row read and written, at
3.35 TB/s.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.obs import costs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sketch import u64

THREADS = 512  # a block's threads (csrc/bank_count.cu's kThreads)
BLOCK_ITEMS = 4 * 4 * THREADS  # keys a block loads in one turn (four 16-byte loads a thread)
# Rows whose uint32 bins a block holds in shared memory: 64 KiB, three
# blocks an SM in the H100's 227 KB; more rows take the global path.
SHARED_ROWS = 1 << 14
# Measured on an H100 (80GB HBM3, 700 W; device us a call; PERF.md):
# at the fleet tick (1024 rows, 2^25 Zipf(1.2) keys) 1, 2 and 4 blocks an SM
# took 71.9, 60.6 and 63.2 (2: 52.7 in later rounds).  A shared-path block
# counts at least as many keys as it has bins, since it zeroes and flushes
# every bin: at 16384 rows and bench_sparse's chunk of 909,312 keys, at
# least 1, 2, 4 and 8 keys a bin took 11.7, 13.7, 17.3 and 25.5 (the global
# path 18.5).
BLOCKS_PER_SM = 2
# The global path's table a block (csrc/bank_count.cu's kSlotBits, kProbes,
# kHash): 2^13 slots of an int32 key and a uint32 count (64 KiB); a key
# starts at slot (key * TALLY_HASH mod 2^32) >> 19 and probes TALLY_PROBES
# slots in turn.
TALLY_SLOTS = 1 << 13
TALLY_PROBES = 4
TALLY_HASH = 0x9E3779B1

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 4
)


def bank_count_path(rows: int) -> str:
    """"shared" or "global": the path ``bank_row_count`` takes for a bank of
    ``rows`` rows."""
    return "shared" if rows <= SHARED_ROWS else "global"


def count_split(n: int, rows: int, sms: int) -> Tuple[int, int]:
    """(per, blocks): block b counts keys [b * per, min(n, (b + 1) * per)),
    ``per`` a multiple of 4 (the 16-byte loads start on a quad); at most
    BLOCKS_PER_SM blocks an SM, at least a turn of loads a block, and on
    the shared path at least a key a bin, on the global path a key a slot."""
    least = max(BLOCK_ITEMS, rows if bank_count_path(rows) == "shared" else TALLY_SLOTS)
    blocks = max(1, min(BLOCKS_PER_SM * sms, n // least))
    per = -(-n // blocks)
    per = -(-per // 4) * 4
    return per, -(-n // per)


def _check(limbs: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    if limbs.dim() != 2 or limbs.shape[1] != 2 or limbs.dtype != torch.int64:
        raise ValueError(f"limbs must be (B, 2) int64, got {tuple(limbs.shape)} {limbs.dtype}")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    return keys.reshape(-1).contiguous()


def bank_row_count_plain(limbs: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``bincount`` of the keys in [0, B) (the
    others routed to a trailing bin that is cut off), then the (hi, lo) limb
    add, exact to 2^64."""
    keys = _check(limbs, keys)
    rows = limbs.shape[0]
    valid = (keys >= 0) & (keys < rows)
    routed = torch.where(valid, keys, rows).to(torch.int64)
    counts = torch.bincount(routed, minlength=rows + 1)[:rows]
    return u64.add(limbs, u64.limbs(counts.to(torch.int64)))


def bank_row_count(limbs: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(B, 2) int64 (hi, lo) limbs + the count of each row's keys in a flat
    int32 stream -> new limbs, exact to 2^64; keys outside [0, B) dropped.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    of the path ``bank_count_path`` picks from the shape and counts it in
    ``bank.counters.shared`` or ``bank.counters.global``.  The result is a
    fresh tensor: ``limbs`` is never written.
    """
    if limbs.device.type == "cpu" and keys.device.type == "cpu":
        return bank_row_count_plain(limbs, keys)
    keys = _check(limbs, keys)
    rows, n = limbs.shape[0], keys.numel()
    if _build.on_meta(limbs, keys):
        costs.kernel("bank_row_count", *_cost(rows, n))
        return torch.empty_like(limbs)
    device = _build.require_cuda(limbs, keys)
    if n == 0 or rows == 0:
        return limbs.clone(memory_format=torch.contiguous_format)
    path = bank_count_path(rows)
    per, blocks = count_split(n, rows, _build.sm_count(device))
    limbs = limbs.contiguous()
    out = torch.empty_like(limbs)
    scratch = torch.empty(rows, dtype=torch.int64, device=device)
    _build.launch("bank_row_count", "bank_count", "bank_count_launch", _ARGTYPES, device,
                  (keys.data_ptr(), n, rows, per, blocks, int(path == "shared"), limbs.data_ptr(), out.data_ptr(),
                   scratch.data_ptr()),
                  *_cost(rows, n))
    obs_metrics.inc(f"bank.counters.{path}")
    return out


def _cost(rows: int, n: int):
    """4 B a key read once, 16 B a row read and written."""
    return 0, 4 * n + 32 * rows
