"""Aggregation backends behind the ExecutionPlan registry.

Port of ``repro/sketch/backends.py`` for the main path.  Three backends
ship on each of the two axes, all bit-identical on the same stream (the
max-lattice makes slicing invisible -- DESIGN.md §6):

  torch           eager PyTorch scatter-max; ``pipelines`` k slices the
                  stream into k sub-sketches folded by max (Fig. 3)
  cuda            the fused hand-written kernel (hash, rank, register max)
  cuda_pipelined  k fused launches + the bucket-fold kernel

Bank ingest (DESIGN.md §9): ``torch`` is one scatter-max over the flattened
(key, bucket) cells; ``cuda`` and ``cuda_pipelined`` run the hash_rank
kernel, then the bank_scatter kernel.

Three more axes carry the hybrid and windowed carriers, with the same three
names on each:

  window fold   (DESIGN.md §11)  torch: where + amax over the W axis;
                                 cuda*: the window_fold_max kernel
  window merge  (DESIGN.md §14)  torch: amax over the K fragments;
                                 cuda*: the window_merge_max kernel
  sparse dedup  (DESIGN.md §12)  torch: a two-pass stable argsort, or a
                                 scatter-amax into zeroed cells once the
                                 stream rivals the bank; cuda*: the
                                 sparse_scatter_coo kernel (cells layout)

The count-min family (DESIGN.md §13) registers the same three names on its
two axes:

  cm ingest + query  torch: ``cm_hash_index`` + one ``index_add_`` over the
                     flattened (key, depth, column) cells; cuda*: the
                     cm_scatter_add kernel (hash and d atomic hits fused).
                     The query is the same gather-min under every backend,
                     as in the reference.
  cm window fold     torch: where + an int32 sum over the W axis; cuda*:
                     the cm_window_fold_sum kernel

The reference pads streams to its kernels' (rows, 128) tiles; the CUDA
wrappers take flat streams of any length and mask their own ragged edge,
so no padding happens here.  On CPU tensors every kernel wrapper runs its
plain version, so every backend runs on both devices.
"""

from __future__ import annotations

import torch

from repro_torch.sketch import hll
from repro_torch.sketch.hll import HLLConfig
from repro_torch.sketch.plan import (
    DEFAULT_PIPELINES,
    ExecutionPlan,
    SparseDedup,
    register_backend,
    register_bank_backend,
    register_cm_backend,
    register_cm_window_backend,
    register_sparse_backend,
    register_window_backend,
    register_window_merge_backend,
)


# The kernel modules import repro_torch.sketch.hll, so they load at the
# first wrapper call rather than at import (as in the reference), which
# also keeps this module free of any build step.
def _kernels():
    from repro_torch.kernels import bank_scatter, bucket_fold, hash_rank, hll_fused

    return hash_rank, hll_fused, bucket_fold, bank_scatter


def _ring_kernels():
    from repro_torch.kernels import sparse_scatter, window_fold

    return sparse_scatter, window_fold


def _cm_kernels():
    from repro_torch.kernels import cm_scatter

    return cm_scatter


# ----------------------------------------------------------------------------
# torch backend (reference scatter path + lane-pipelined variant)
# ----------------------------------------------------------------------------


def update_pipelined(
    registers: torch.Tensor,
    items: torch.Tensor,
    cfg: HLLConfig,
    pipelines: int = DEFAULT_PIPELINES,
) -> torch.Tensor:
    """Fig. 3 on one device: slice the stream over k pipelines, fold with max.

    Each pipeline's bucket ids are offset by its index * m so one
    scatter-max builds every partial sketch; any length is accepted and the
    result is bit-identical to the single-pipeline path.
    """
    flat = items.reshape(-1)
    n = flat.shape[0]
    if pipelines <= 1 or n == 0:
        return hll.update(registers, flat, cfg)
    idx, rank = hll.hash_index_rank(flat, cfg)
    per = -(-n // pipelines)
    lane = torch.arange(n, device=flat.device) // per
    seg = lane * cfg.m + idx.to(torch.int64)
    partial = torch.zeros(
        (pipelines * cfg.m,), dtype=hll.REGISTER_DTYPE, device=registers.device
    )
    partial.scatter_reduce_(0, seg, rank.to(hll.REGISTER_DTYPE), "amax")
    folded = torch.amax(partial.reshape(pipelines, cfg.m), dim=0)
    return torch.maximum(registers, folded)


# ----------------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------------


def hash_rank(items: torch.Tensor, cfg: HLLConfig):
    """Fused murmur3+rank of a flat item stream -> (idx, rank) int32 tensors."""
    _hash, _, _, _ = _kernels()
    return _hash.hash_rank(hll.as_items(items), cfg)


def bucket_fold(partials: torch.Tensor) -> torch.Tensor:
    """Fold (k, m) uint8 or int32 partial registers -> (m,) by max."""
    _, _, _fold, _ = _kernels()
    return _fold.bucket_fold(partials)


def hll_update(
    registers: torch.Tensor, items: torch.Tensor, cfg: HLLConfig
) -> torch.Tensor:
    """Fully-fused aggregation of a flat stream into (m,) uint8 registers."""
    _, _fused, _, _ = _kernels()
    return _fused.hll_update_fused(registers, hll.as_items(items), None, cfg)


def pipelined_update(
    registers: torch.Tensor,
    items: torch.Tensor,
    cfg: HLLConfig,
    pipelines: int = DEFAULT_PIPELINES,
) -> torch.Tensor:
    """Paper Fig. 3 built from the kernels: k fused pipelines + fold kernel.

    Slices the stream across ``pipelines`` sub-sketches, aggregates each
    with the fused kernel, folds the partials with the bucket_fold kernel,
    and merges into the running registers.
    """
    flat = hll.as_items(items)
    per = -(-flat.shape[0] // pipelines)
    zeros = torch.zeros_like(registers)
    partials = torch.stack(
        [hll_update(zeros, flat[k * per : (k + 1) * per], cfg) for k in range(pipelines)]
    )
    return torch.maximum(registers, bucket_fold(partials))


# ----------------------------------------------------------------------------
# registry entries: fn(registers, items, cfg, plan) -> registers
# ----------------------------------------------------------------------------


@register_backend("torch")
def _torch_backend(registers, items, cfg: HLLConfig, plan: ExecutionPlan):
    return update_pipelined(registers, items, cfg, plan.pipelines)


@register_backend("cuda")
def _cuda_backend(registers, items, cfg: HLLConfig, plan: ExecutionPlan):
    # the fused kernel is one hardware pipeline; k>1 belongs to
    # "cuda_pipelined", so `pipelines` is intentionally not consulted here.
    return hll_update(registers, items, cfg)


@register_backend("cuda_pipelined")
def _cuda_pipelined_backend(registers, items, cfg: HLLConfig, plan: ExecutionPlan):
    return pipelined_update(registers, items, cfg, plan.pipelines)


# ----------------------------------------------------------------------------
# SketchBank ingest paths (keyed scatter-max; DESIGN.md §9)
# ----------------------------------------------------------------------------


def _check_cell_space(registers: torch.Tensor) -> None:
    # the reference's flattened segment ids are int32 (the TPU has no
    # 64-bit datapath); the port keeps its limit so both packages accept
    # the same banks
    bank_rows, m = registers.shape
    if bank_rows * m >= 1 << 31:
        raise ValueError(
            f"bank cell space B*m = {bank_rows}*{m} overflows int32 segment "
            f"ids; split the fleet across multiple banks or mesh shards"
        )


def bank_update_torch(
    registers: torch.Tensor,
    keys: torch.Tensor,
    items: torch.Tensor,
    cfg: HLLConfig,
) -> torch.Tensor:
    """Reference bank ingest: ONE scatter-max over (key, bucket) cells.

    Row b's bucket idx lands in flattened cell ``b*m + idx``.  Out-of-range
    keys route to a discarded trailing cell (never clamped into a
    neighboring row); ``pipelines`` is ignored because the scatter is
    already one fused op.
    """
    _check_cell_space(registers)
    _, _, _, _bank = _kernels()
    idx, rank = hll.hash_index_rank(items, cfg)
    return _bank.bank_scatter_max_plain(registers, keys, idx, rank)


def bank_update(
    registers: torch.Tensor,
    keys: torch.Tensor,
    items: torch.Tensor,
    cfg: HLLConfig,
) -> torch.Tensor:
    """Kernel bank ingest: the hash_rank kernel, then the bank_scatter kernel.

    The scatter kernel drops out-of-range keys itself (the §9 drop rule).
    The reference's ``row_block`` tiling has a counterpart of its own: a
    large bank is cut into tiles of whole rows held in shared memory and
    the stream partitioned by tile, every register written once; a bank
    that stays in L2, or a short stream, takes the global path, byte
    compare-and-swaps into a copy of the bank
    (``bank_scatter.bank_scatter_path``).
    """
    _check_cell_space(registers)
    _, _, _, _bank = _kernels()
    idx, rank = hash_rank(items, cfg)
    return _bank.bank_scatter_max(registers, keys, idx, rank)


@register_bank_backend("torch")
def _torch_bank_backend(registers, keys, items, cfg: HLLConfig, plan: ExecutionPlan):
    return bank_update_torch(registers, keys, items, cfg)


@register_bank_backend("cuda")
def _cuda_bank_backend(registers, keys, items, cfg: HLLConfig, plan: ExecutionPlan):
    return bank_update(registers, keys, items, cfg)


@register_bank_backend("cuda_pipelined")
def _cuda_pipelined_bank_backend(registers, keys, items, cfg: HLLConfig, plan: ExecutionPlan):
    # the reference splits the bank into k row blocks to stay under its
    # VMEM cap; the atomic scatter has no cap, so k pipelines are one launch
    return bank_update(registers, keys, items, cfg)


# ----------------------------------------------------------------------------
# WindowedBank ring folds (masked max over the W axis; DESIGN.md §11)
# ----------------------------------------------------------------------------


@register_window_backend("torch")
def _torch_window_backend(ring, mask, cfg: HLLConfig, plan: ExecutionPlan):
    _, _window = _ring_kernels()
    return _window.window_fold_max_plain(ring, mask)


@register_window_backend("cuda")
def _cuda_window_backend(ring, mask, cfg: HLLConfig, plan: ExecutionPlan):
    _, _window = _ring_kernels()
    return _window.window_fold_max(ring, mask)


@register_window_backend("cuda_pipelined")
def _cuda_pipelined_window_backend(ring, mask, cfg: HLLConfig, plan: ExecutionPlan):
    # the reference tiles the fold over k row blocks to stay under its VMEM
    # cap; the kernel has no cap, so k pipelines are one launch
    _, _window = _ring_kernels()
    return _window.window_fold_max(ring, mask)


# ----------------------------------------------------------------------------
# incremental window merges (K fold fragments -> one bank; DESIGN.md §14)
# ----------------------------------------------------------------------------


@register_window_merge_backend("torch")
def _torch_window_merge_backend(parts, cfg: HLLConfig, plan: ExecutionPlan):
    _, _window = _ring_kernels()
    return _window.window_merge_max_plain(parts)


@register_window_merge_backend("cuda")
def _cuda_window_merge_backend(parts, cfg: HLLConfig, plan: ExecutionPlan):
    _, _window = _ring_kernels()
    return _window.window_merge_max(parts)


@register_window_merge_backend("cuda_pipelined")
def _cuda_pipelined_window_merge_backend(parts, cfg: HLLConfig, plan: ExecutionPlan):
    _, _window = _ring_kernels()
    return _window.window_merge_max(parts)


# ----------------------------------------------------------------------------
# HybridBank sparse dedup (append-buffer compaction; DESIGN.md §12)
# ----------------------------------------------------------------------------

# the torch dedup picks its layout by stream-vs-bank size: below this
# fraction of the bank's rows*m cell count the O(n log n) sort wins, above
# it the O(n + rows*m) scatter does (the reference's crossover, measured on
# its CPU)
_SPARSE_CELLS_CROSSOVER = 32


def _sparse_valid(row, bucket, rank, rows: int, m: int) -> torch.Tensor:
    # the reference drops rows outside [0, rows) only; buckets outside
    # [0, m) and ranks <= 0 never come out of the hash, and dropping them
    # too keeps both layouts (and the kernel) in agreement on any input
    return (row >= 0) & (row < rows) & (bucket >= 0) & (bucket < m) & (rank > 0)


def sparse_merge_sorted(row, bucket, rank, rows: int, m: int):
    """Sorted-stream dedup: two-pass stable argsort over (row, bucket) cells.

    ONE stable sort by rank ascending, then (stably) by ``row * m + bucket``
    cell id, so within each equal-cell run ranks ascend and the LAST element
    carries the cell's max.  Dropped entries sort to a trailing sentinel
    cell and never survive.  Cost tracks the stream, not the bank.
    """
    valid = _sparse_valid(row, bucket, rank, rows, m)
    cell = torch.where(valid, row * m + bucket, rows * m)
    order1 = torch.argsort(rank, stable=True)
    cell1, rank1 = cell[order1], rank[order1]
    order2 = torch.argsort(cell1, stable=True)
    cell_s, rank_s = cell1[order2], rank1[order2]
    is_last = torch.ones_like(cell_s, dtype=torch.bool)
    is_last[:-1] = cell_s[1:] != cell_s[:-1]
    survivor = is_last & (cell_s < rows * m)
    row_s = torch.where(survivor, cell_s // m, rows).to(torch.int64)
    distinct = torch.bincount(row_s, minlength=rows + 1)[:rows].to(torch.int32)
    return cell_s, rank_s, survivor, distinct


@register_sparse_backend("torch")
def _torch_sparse_backend(row, bucket, rank, rows, cfg: HLLConfig, plan: ExecutionPlan):
    m = cfg.m
    if row.shape[0] * _SPARSE_CELLS_CROSSOVER >= rows * m:
        _sparse, _ = _ring_kernels()
        cells, distinct = _sparse.sparse_scatter_coo_plain(row, bucket, rank, rows, m)
        return SparseDedup(distinct=distinct, cells=cells)
    cell_s, rank_s, survivor, distinct = sparse_merge_sorted(row, bucket, rank, rows, m)
    return SparseDedup(distinct=distinct, cell_s=cell_s, rank_s=rank_s, survivor=survivor)


@register_sparse_backend("cuda")
def _cuda_sparse_backend(row, bucket, rank, rows, cfg: HLLConfig, plan: ExecutionPlan):
    _sparse, _ = _ring_kernels()
    cells, distinct = _sparse.sparse_scatter_coo(row, bucket, rank, rows, cfg.m)
    return SparseDedup(distinct=distinct, cells=cells)


@register_sparse_backend("cuda_pipelined")
def _cuda_pipelined_sparse_backend(row, bucket, rank, rows, cfg: HLLConfig, plan: ExecutionPlan):
    # the reference tiles the dedup over k row blocks under its VMEM cap;
    # the atomic scatter has no cap, so k pipelines are one launch
    _sparse, _ = _ring_kernels()
    cells, distinct = _sparse.sparse_scatter_coo(row, bucket, rank, rows, cfg.m)
    return SparseDedup(distinct=distinct, cells=cells)


# ----------------------------------------------------------------------------
# CountMinBank paths (keyed scatter-add + gather-min; DESIGN.md §13)
# ----------------------------------------------------------------------------


def cm_update_torch(counters: torch.Tensor, keys: torch.Tensor, items: torch.Tensor, cfg) -> torch.Tensor:
    """Reference cm ingest: ONE ``index_add_`` over (key, depth, column) cells.

    Item i with key b adds 1 at flattened cell ``b*d*w + r*w + idx_r(i)``
    of each depth row r; out-of-range keys route to a discarded trailing
    cell (the §9 drop rule).  Counters are int32 holding uint32 bits and
    wrap mod 2^32.  B*d*w >= 2^31 is rejected loudly, as in the reference.
    """
    return _cm_kernels().cm_scatter_add_plain(counters, keys, items, cfg)


def cm_update(counters: torch.Tensor, keys: torch.Tensor, items: torch.Tensor, cfg) -> torch.Tensor:
    """Kernel cm ingest: the cm_scatter_add kernel hashes each item and lands
    its d hits with atomics.  The reference's d-expanded, tiled stream and
    its ``row_block`` slabs under the VMEM cap have no counterpart."""
    return _cm_kernels().cm_scatter_add(counters, keys, items, cfg)


def cm_query_torch(counters: torch.Tensor, items: torch.Tensor, cfg) -> torch.Tensor:
    """Reference cm point query: gather d cells per (row, item), min-reduce.

    Returns (B, n) int64 estimates: the min over d is taken on the
    counters' unsigned values (a counter past 2^31 is negative as int32
    and must not win).  A gather-min has no scatter hazard for a kernel to
    fuse away, so every backend shares this query, as in the reference.
    """
    from repro_torch.sketch import countmin

    depth = counters.shape[1]
    idx = countmin.cm_hash_index(items, cfg).to(torch.int64)  # (d, n)
    r = torch.arange(depth, device=counters.device)[:, None]
    return countmin.unsigned(counters[:, r, idx]).amin(dim=1)  # (B, d, n) -> (B, n)


def _torch_cm_ingest(counters, keys, items, cfg, plan: ExecutionPlan):
    # the scatter-add is already one fused op; `pipelines` has no fold to
    # parallelize, exactly as in bank_update_torch
    return cm_update_torch(counters, keys, items, cfg)


def _cuda_cm_ingest(counters, keys, items, cfg, plan: ExecutionPlan):
    return cm_update(counters, keys, items, cfg)


def _cm_query(counters, items, cfg, plan: ExecutionPlan):
    return cm_query_torch(counters, items, cfg)


register_cm_backend("torch", _torch_cm_ingest, _cm_query)
register_cm_backend("cuda", _cuda_cm_ingest, _cm_query)
# the reference tiles the bank over k row blocks to stay under its VMEM cap;
# the atomic scatter has no cap, so k pipelines are one launch
register_cm_backend("cuda_pipelined", _cuda_cm_ingest, _cm_query)


@register_cm_window_backend("torch")
def _torch_cm_window_backend(ring, mask, cfg, plan: ExecutionPlan):
    return _cm_kernels().cm_window_fold_sum_plain(ring, mask)


@register_cm_window_backend("cuda")
def _cuda_cm_window_backend(ring, mask, cfg, plan: ExecutionPlan):
    return _cm_kernels().cm_window_fold_sum(ring, mask)


@register_cm_window_backend("cuda_pipelined")
def _cuda_pipelined_cm_window_backend(ring, mask, cfg, plan: ExecutionPlan):
    # the reference tiles the fold over k row blocks under its VMEM cap;
    # the kernel has no cap, so k pipelines are one launch
    return _cm_kernels().cm_window_fold_sum(ring, mask)
