"""The single aggregation entry point: update_registers(regs, items, cfg, plan).

Port of ``repro/sketch/dispatch.py``: ``update_registers``, ``dedup_pairs``,
``datapath_tap`` and the four placement rules (``mesh_fold``, ``row_shard_fold``,
``row_shard_apply``, ``cm_mesh_sum``).  The ``ExecutionPlan`` chooses the
backend and placement, and every plan yields bit-identical registers on the
same stream (DESIGN.md §3).

The reference runs its placements as ``shard_map`` inside one process and
returns the replicated state to its one caller.  The port keeps that
single-controller model: a rule runs each shard on the device of its mesh
position (``Mesh.shard_devices``), from the calling process, and its
"collective" is a copy to the caller's device plus a ``torch.maximum`` (or
an add) there.  Shards on one device run one after another.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.obs import costs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sketch import hll
from repro_torch.sketch.hll import HLLConfig
from repro_torch.sketch.plan import (
    DEFAULT_PLAN,
    ExecutionPlan,
    SparseDedup,
    get_backend,
    get_sparse_backend,
)


def _shard_count(plan: ExecutionPlan) -> int:
    return math.prod(plan.mesh.shape[a] for a in plan.data_axes)


def _shard_devices(plan: ExecutionPlan):
    return plan.mesh.shard_devices(plan.data_axes)


def _pad_rows(x: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended along ``dim`` up to ``rows``."""
    extra = rows - x.shape[dim]
    if extra == 0:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _gathered(kind: str, part: torch.Tensor, position: int) -> torch.Tensor:
    """``part``, computed at mesh position ``position``, as it reaches the
    caller (position 0): its bytes are declared moved between positions,
    the op analysis's collective bytes (``repro_torch.obs.costs``)."""
    if position:
        costs.collective(kind, part.numel() * part.element_size())
    return part


def mesh_fold(plan: ExecutionPlan, registers, arrays, apply_fn):
    """The mesh placement rule, shared by sketch and bank dispatch.

    ``arrays`` is a tuple of equal-length flat streams (the item stream;
    or the key + item streams for a bank, DESIGN.md §9).  Each is split
    into contiguous shards over ``plan.data_axes``; every shard applies
    ``apply_fn(registers, *local_arrays)`` on its device to its own copy
    of the registers, and the partial states fold by max onto the
    registers' device -- the paper's Merge-buckets module as one fold.
    Streams that do not divide the shard count are edge-padded: zero
    padding would sketch phantom elements, while repeating a real element
    (or (key, item) pair) cannot move any register -- the lattice is
    idempotent (DESIGN.md §6) -- so no plan ever raises on stream length.
    """
    shards = _shard_count(plan)
    n = arrays[0].shape[0]
    padded = -(-n // shards) * shards
    if padded != n:
        arrays = tuple(torch.cat([x, x[-1:].expand(padded - n)]) for x in arrays)
    per = padded // shards
    home = registers.device
    folded = None
    for i, dev in enumerate(_shard_devices(plan)):
        part = _gathered("all-reduce", apply_fn(
            registers.to(dev, copy=True), *(x[i * per : (i + 1) * per].to(dev) for x in arrays)
        ), i).to(home)
        folded = part if folded is None else torch.maximum(folded, part)
    return folded


def row_shard_fold(plan: ExecutionPlan, registers, keys, arrays, apply_fn):
    """The sharded placement rule for keyed bank ingest (DESIGN.md §16).

    ``registers`` is a (B, ...) bank whose ROW axis splits into contiguous
    blocks over ``plan.data_axes``; ``keys`` and the ``arrays`` streams go
    whole to every block.  Each block re-bases the key stream into
    block-local coordinates (``key - block_start``, wrapping int32 as the
    reference's does) and applies ``apply_fn(block, local_keys,
    *arrays)`` on its device: keys owned by another block fall outside
    [0, block_rows) and the §9 drop rule discards them, so routing is the
    drop rule itself.  Row counts that do not divide the shard count pad
    with phantom rows (valid keys are < B by the same rule, so nothing can
    land in them) and slice back.  The union of the blocks is exactly one
    local update: bit-identity to placement="local" holds by construction.
    """
    shards = _shard_count(plan)
    rows = registers.shape[0]
    block = -(-rows // shards)
    regs = _pad_rows(registers, 0, block * shards)
    home = registers.device
    outs = []
    for i, dev in enumerate(_shard_devices(plan)):
        local_keys = (keys - i * block).to(dev)
        outs.append(_gathered("all-gather", apply_fn(
            regs[i * block : (i + 1) * block].to(dev), local_keys, *(x.to(dev) for x in arrays)
        ), i).to(home))
    return torch.cat(outs)[:rows]


def row_shard_apply(plan: ExecutionPlan, fn, arrays: Sequence, in_dims: Sequence, out_dim: int = 0):
    """Apply a ROW-INDEPENDENT map block-wise under the sharded placement.

    The read-side companion of :func:`row_shard_fold`: ``fn`` maps each
    array's row block to a per-row result (batched estimate finalization,
    window ring folds -- anything with no cross-row dataflow), so running
    it per block and concatenating is the unsharded call row for row.
    ``in_dims[i]`` names the row dimension of ``arrays[i]`` (None passes
    the whole array to every block); the output's row dimension is
    ``out_dim``.  Non-divisible row counts pad with phantom zero rows --
    inert under every row-wise map here -- and slice back.
    """
    shards = _shard_count(plan)
    rows = next(a.shape[d] for a, d in zip(arrays, in_dims) if d is not None)
    block = -(-rows // shards)
    staged = [a if d is None else _pad_rows(a, d, block * shards) for a, d in zip(arrays, in_dims)]
    home = staged[0].device
    outs = []
    for i, dev in enumerate(_shard_devices(plan)):
        args = [
            (a if d is None else a.narrow(d, i * block, block)).to(dev)
            for a, d in zip(staged, in_dims)
        ]
        outs.append(_gathered("all-gather", fn(*args), i).to(home))
    return torch.cat(outs, dim=out_dim).narrow(out_dim, 0, rows)


def cm_mesh_sum(plan: ExecutionPlan, counters, arrays, apply_fn):
    """The mesh placement rule for ADDITIVE sketch state (count-min).

    ``mesh_fold`` edge-pads non-divisible streams because repeating a
    (key, item) pair cannot move a max-lattice register -- but under a sum
    it would double-count.  Here padding fills the key stream with -1
    instead, which the §9 drop rule discards on every backend, and the
    other streams with zeros.  Each shard ingests into a ZERO counter bank
    on its device, the deltas sum as wrapping int32 (the counters' uint32
    bits) on the counters' device, and the sum lands on the incoming
    counters exactly once.
    """
    shards = _shard_count(plan)
    n = arrays[0].shape[0]
    padded = -(-n // shards) * shards
    if padded != n:
        keys, rest = arrays[0], arrays[1:]
        arrays = (torch.cat([keys, keys.new_full((padded - n,), -1)]),) + tuple(
            torch.cat([x, x.new_zeros((padded - n,))]) for x in rest
        )
    per = padded // shards
    home = counters.device
    delta = None
    for i, dev in enumerate(_shard_devices(plan)):
        zeros = torch.zeros(counters.shape, dtype=counters.dtype, device=dev)
        part = _gathered("all-reduce", apply_fn(zeros, *(x[i * per : (i + 1) * per].to(dev) for x in arrays)),
                         i).to(home)
        delta = part if delta is None else delta + part
    return counters + delta


def update_registers(
    registers: torch.Tensor,
    items,
    cfg: HLLConfig,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """Aggregate ``items`` into ``registers`` under ``plan`` (Phase 3).

    Items go to the registers' device first.  An empty stream cannot move a
    register and returns ``registers`` without any backend dispatch.

    placement="local": the backend runs on the registers' device as-is.
    placement="mesh":  the flat stream is sharded over ``plan.data_axes``
    through :func:`mesh_fold` (per-shard aggregation + one max fold;
    edge-padding for non-divisible streams).  placement="sharded" degrades
    to the mesh rule here: a single sketch has no row axis to split, and
    stream-sharding is bit-identical to local by the same lattice laws
    (DESIGN.md §16).
    """
    plan = (DEFAULT_PLAN if plan is None else plan).validate()
    backend = get_backend(plan.backend)
    flat = hll.as_items(items, registers.device)
    if flat.shape[0] == 0:
        # skips are counted so the no-dispatch contract stays observable
        obs_metrics.inc("dispatch.update.skipped_empty")
        return registers
    obs_metrics.observe("update.batch_items", flat.shape[0])
    if plan.placement == "local":
        return backend(registers, flat, cfg, plan)
    return mesh_fold(plan, registers, (flat,), lambda regs, x: backend(regs, x, cfg, plan))


def dedup_pairs(
    row: torch.Tensor,
    bucket: torch.Tensor,
    rank: torch.Tensor,
    rows: int,
    cfg: HLLConfig,
    plan: Optional[ExecutionPlan] = None,
) -> SparseDedup:
    """Dedup a (row, bucket, rank) int32 triple stream under ``plan`` (DESIGN.md §12).

    The HybridBank compaction's dispatch seam, mirroring
    :func:`update_registers`: the sparse-capable backend registered under
    ``plan.backend`` collapses the combined live-pair + append-buffer
    stream to each row's distinct bucket -> max-rank map and per-row
    distinct counts.  The dedup always runs on the caller's device
    whatever the placement: compaction consumes the carrier's COO state,
    so there is no stream to shard (mesh plans shard the *ingest* phases
    instead).  A backend name with no sparse registration (a plugin
    bank backend) falls back to the torch dedup: every sparse path is
    bit-identical by contract.  "torch", "cuda" and "cuda_pipelined" all
    register, so the fallback never hides a kernel.
    """
    plan = (DEFAULT_PLAN if plan is None else plan).validate()
    try:
        backend = get_sparse_backend(plan.backend)
    except ValueError:
        obs_metrics.inc("dispatch.sparse_dedup.fallback")
        backend = get_sparse_backend("torch")
    return backend(row, bucket, rank, rows, cfg, plan)


def datapath_tap(registers: torch.Tensor, token_ids: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    """Sketch-on-the-datapath inside the training step (the NIC analogue,
    DESIGN.md §2): the step's tokens, already on the device, aggregated into
    the registers.  The reference's tap is ``hll.update``, which its
    docstring calls equivalent to ``update_registers`` with the
    single-pipeline plan; the port runs ``update_registers`` under
    ``DEFAULT_PLAN`` -- one ``hll_update_fused`` launch on the card, its
    plain version on the CPU -- and the registers are bit-identical."""
    return update_registers(registers, token_ids, cfg, DEFAULT_PLAN)
