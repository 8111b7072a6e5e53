"""The single aggregation entry point: update_registers(regs, items, cfg, plan).

Port of ``repro/sketch/dispatch.py::update_registers`` and ``dedup_pairs``
for placement="local" (the plan itself refuses the other placements until the
placement slice, ROADMAP A.10).  The ``ExecutionPlan`` chooses the backend,
and every plan yields bit-identical registers on the same stream
(DESIGN.md §3).
"""

from __future__ import annotations

from typing import Optional

import torch

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


def update_registers(
    registers: torch.Tensor,
    items,
    cfg: HLLConfig,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """Aggregate ``items`` into ``registers`` under ``plan`` (Phase 3).

    Items go to the registers' device first.  An empty stream cannot move a
    register and returns ``registers`` without any backend dispatch.
    """
    plan = (DEFAULT_PLAN if plan is None else plan).validate()
    backend = get_backend(plan.backend)
    flat = hll.as_items(items, registers.device)
    if flat.shape[0] == 0:
        # skips are counted so the no-dispatch contract stays observable
        obs_metrics.inc("dispatch.update.skipped_empty")
        return registers
    obs_metrics.observe("update.batch_items", flat.shape[0])
    return backend(registers, flat, cfg, plan)


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
    distinct counts.  A backend name with no sparse registration (a plugin
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


def cm_mesh_sum(plan: ExecutionPlan, counters, arrays, apply_fn):
    """The mesh placement rule for ADDITIVE sketch state (count-min).

    The reference pads the key stream with -1 (dropped on every backend),
    ingests each device's shard into a zero bank and sums the deltas with
    one collective.  The port runs placement="local" only until the
    placement slice (ROADMAP A.10); the plan already refuses "mesh", so
    this is reached only by a plan built around that check.
    """
    raise NotImplementedError(
        f"placement={plan.placement!r} is not ported yet: count-min mesh "
        f"ingest waits for the placement slice (ROADMAP A.10)"
    )
