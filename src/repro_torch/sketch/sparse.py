"""Sparse tenant-row storage with automatic dense promotion (DESIGN.md §12).

Port of ``repro/sketch/sparse.py``.  A ``HybridBank`` keeps every row in one
of two representations, all of it in tensors on the bank's device:

* **sparse** -- the row's distinct ``(bucket_idx, rank)`` pairs, packed as
  ``bucket << 8 | rank`` int32 values in a per-row COO buffer of shape
  (B, C), with C fitted to the occupancy of the sparse rows at each
  compaction;
* **dense** -- the usual (m,) uint8 register row, held in a compact (D, m)
  block that only promoted rows occupy (``slot_map`` maps row -> block
  slot, -1 for sparse rows).

**Promotion contract.** A row is promoted exactly when its distinct-bucket
count exceeds ``threshold`` (default m // 4).  Promotion materializes the
row's full bucket -> max-rank map, so a promoted row's registers are
bit-identical to dense-from-scratch ingestion of the same stream.
Promotion is one-way; ``merge`` keeps dense mode infectious.

**Amortized ingest.** ``update_many(keys, items, plan)`` routes the keyed
stream on the device: dense-destined items go straight through the bank
backend registered under ``plan.backend`` (the §9 scatter), sparse-destined
items append raw to a per-bank log of (key, item) tensors on the bank's
device -- no hash, no dedup.  Compaction (dedup, recompaction, promotion)
runs only under capacity pressure (the log outgrowing
``max(_FLUSH_MIN_PAIRS, _FLUSH_FACTOR * live pairs)``) or before any read,
and is bit-identical to deduplicating every batch eagerly (register max is
an associative, commutative, idempotent lattice).  Compaction hashes the
log (the hash_rank kernel under "cuda"/"cuda_pipelined"), re-emits the live
pairs as triples and dispatches the combined stream through
``dedup_pairs`` (the sparse registry axis: the sparse_scatter kernel, or
the torch sort/scatter); the recompaction of its result runs on the device
too, with ``torch.nonzero`` in row-major order giving the sorted layout's
slot order.  The reference routes and recompacts with host numpy; here the
tick's stream never leaves the card, and the host reads back only the few
scalars that size the new buffers.

**Estimation.** Sparse rows finalize with the LinearCounting fast path
``m * log(m / (m - len))``, written as the dense device path writes its
small-range branch, so on the card it is bit-identical to it; other
estimators build the (B, K) histogram straight from the pairs.

**Wire format v2** (RHLB, version 2) is byte-identical to the reference's;
``from_bytes`` still accepts v1 dense blobs as an all-dense bank.

Entry points run on the card unless the caller asks for the CPU:
``empty`` and ``from_bytes`` default to ``torch.device("cuda")``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.bank_count import bank_row_count
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sketch import hll, u64
from repro_torch.sketch.bank import (
    _BANK_HEADER,
    _BANK_MAGIC,
    _ROW_COUNT,
    SketchBank,
    _flat_keys_items,
    estimate_rows,
    update_bank_registers,
)
from repro_torch.sketch.carrier import HyperLogLog
from repro_torch.sketch.dispatch import dedup_pairs
from repro_torch.sketch.hll import HLLConfig
from repro_torch.sketch.plan import DEFAULT_PLAN, ExecutionPlan, SparseDedup

_PACK_SHIFT = 8  # packed pair = bucket << 8 | rank (rank <= 61 fits a byte)
_PACK_MASK = (1 << _PACK_SHIFT) - 1
_EMPTY = -1  # empty-slot sentinel in the packed pair buffer
_SPARSE_VERSION = 2
_THRESHOLD = struct.Struct("<I")
_NPAIRS = struct.Struct("<H")
MODE_SPARSE, MODE_DENSE = 0, 1

# Append-log pressure policy (DESIGN.md §12): a compaction is forced from
# inside update_many only once the logged raw pairs pass BOTH floors -- an
# absolute floor and a multiple of the live deduped pairs, so each
# compaction ingests at least _FLUSH_FACTOR times the pairs it re-sorts
# (total compaction work O(total appends)).
_FLUSH_MIN_PAIRS = 1 << 22
_FLUSH_FACTOR = 4

# backends whose compaction hashes the log with the hash_rank kernel (the
# same bits as the plain hash); every other backend hashes in plain torch
_KERNEL_HASH_BACKENDS = ("cuda", "cuda_pipelined")


def default_threshold(cfg: HLLConfig) -> int:
    """The default promotion threshold: m // 4 distinct buckets."""
    return max(1, cfg.m // 4)


def _check_threshold(threshold: int, cfg: HLLConfig) -> int:
    """Thresholds above m // 2 would leave the LC-regime guarantee."""
    threshold = int(threshold)
    if not 1 <= threshold <= max(1, cfg.m // 2):
        raise ValueError(
            f"sparse threshold must be in [1, {max(1, cfg.m // 2)}] "
            f"(m // 2 keeps sparse rows in the LinearCounting regime), "
            f"got {threshold}"
        )
    return threshold


def _check_cell_space(rows: int, m: int) -> None:
    """The one guard for every dedup entry: flattened (row, bucket) cell
    ids must fit int32, as in the reference."""
    if rows * m >= 1 << 31:
        raise ValueError(
            f"bank cell space B*m = {rows}*{m} overflows int32 sort "
            f"cells; split the fleet across multiple banks"
        )


def _fit_capacity(needed: int, threshold: int) -> int:
    """Smallest pow2-ish pair capacity holding ``needed`` entries."""
    if needed <= 0:
        return 0
    return min(threshold, max(4, 1 << (needed - 1).bit_length()))


@dataclasses.dataclass(frozen=True)
class _PendingLog:
    """The append log: raw sparse-destined (keys, items) int32 chunks.

    The chunks are tensors on the bank's device; appending is a tuple
    concat -- no hash, no dedup.  ``plan`` remembers the most recent ingest
    plan so a read-triggered compaction runs the sparse backend the writer
    chose.
    """

    chunks: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    total: int
    plan: ExecutionPlan


# ----------------------------------------------------------------------------
# device passes of compaction (all torch ops on the bank's device)
# ----------------------------------------------------------------------------


def _hash_stream(items: torch.Tensor, cfg: HLLConfig, plan: ExecutionPlan):
    """(idx, rank) of the logged items: the hash_rank kernel for the kernel
    backends, the plain hash for "torch" and plugins (the same bits)."""
    if plan.backend in _KERNEL_HASH_BACKENDS:
        from repro_torch.sketch import backends

        return backends.hash_rank(items, cfg)
    return hll.hash_index_rank(items, cfg)


def _exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    counts = counts.to(torch.int64)
    return torch.cumsum(counts, 0) - counts


def _compact_pairs(cell_s, rank_s, survivor, keep_row, *, rows: int, m: int, cap: int):
    """Scatter surviving pairs of still-sparse rows into a (B, cap) buffer.

    Survivors arrive sorted by (row, bucket); each kept entry's slot is
    its running index within its row, so the output rows are bucket-sorted
    with ``-1`` padding -- the invariant the v2 wire format serializes.
    """
    row_s = cell_s // m
    bucket_s = cell_s - row_s * m
    safe_row = torch.clamp(row_s, 0, rows - 1).to(torch.int64)
    take = survivor & keep_row[safe_row] & (row_s < rows)
    pos = torch.cumsum(take.to(torch.int64), 0) - 1
    row_counts = torch.bincount(
        torch.where(take, row_s, rows).to(torch.int64), minlength=rows + 1
    )[:rows]
    offset = pos - _exclusive_cumsum(row_counts)[safe_row]
    idx = torch.where(take & (offset < cap), safe_row * cap + offset, rows * cap)
    out = torch.full((rows * cap + 1,), _EMPTY, dtype=torch.int32, device=cell_s.device)
    out.scatter_(0, idx, ((bucket_s << _PACK_SHIFT) | rank_s).to(torch.int32))
    return out[: rows * cap].reshape(rows, cap)


def _compact_cells(cells, keep_row, distinct, *, cap: int):
    """Dense-cells twin of ``_compact_pairs``: (B, m) max-rank map -> pairs.

    ``torch.nonzero`` over the flattened map lists each row's buckets in
    ascending order, row after row -- the slot order of the sorted layout,
    so both layouts compact to bit-identical buffers.  ``distinct`` is
    every row's nonzero-cell count, so a cell's slot is its position in
    the list minus its row's start.
    """
    rows, m = cells.shape
    flat = cells.reshape(-1)
    nz = torch.nonzero(flat).squeeze(1)
    r = nz // m
    c = nz - r * m
    off = torch.arange(nz.shape[0], device=cells.device) - _exclusive_cumsum(distinct)[r]
    take = keep_row[r] & (off < cap)
    idx = torch.where(take, r * cap + off, rows * cap)
    packed = (c.to(torch.int32) << _PACK_SHIFT) | flat[nz].to(torch.int32)
    out = torch.full((rows * cap + 1,), _EMPTY, dtype=torch.int32, device=cells.device)
    out.scatter_(0, idx, packed)
    return out[: rows * cap].reshape(rows, cap)


def _materialize_rows(cell_s, rank_s, survivor, slot_of_row, *, slots: int, rows: int, m: int):
    """Scatter surviving pairs of promoted rows into fresh dense registers.

    ``slot_of_row`` maps each promoted row to a local slot in [0, slots);
    every other row maps to -1 and contributes nothing.  The scatter sees
    the row's FULL deduped bucket -> max-rank map, so the registers are
    bit-identical to dense-from-scratch ingestion.
    """
    row_s = cell_s // m
    bucket_s = cell_s - row_s * m
    slot = slot_of_row[torch.clamp(row_s, 0, rows - 1).to(torch.int64)]
    take = survivor & (row_s < rows) & (slot >= 0)
    seg = torch.where(take, slot.to(torch.int64) * m + bucket_s, slots * m)
    regs = torch.zeros(slots * m + 1, dtype=hll.REGISTER_DTYPE, device=cell_s.device)
    regs.scatter_reduce_(0, seg, torch.where(take, rank_s, 0).to(hll.REGISTER_DTYPE), "amax")
    return regs[: slots * m].reshape(slots, m)


def _dedup_products(dd: SparseDedup, keep, slot_of_row, dense_rows, *, rows: int, m: int, cap: int):
    """Compacted (B, cap) pairs + (slots, m) dense registers from a dedup.

    Handles both :class:`SparseDedup` layouts; ``dense_rows`` lists the rows
    of ``slot_of_row`` in ascending order (slot i belongs to
    ``dense_rows[i]``).  In the cells layout the map IS the register row,
    so a dense row is a gather.
    """
    slots = int(dense_rows.shape[0])
    if dd.cells is not None:
        pairs = _compact_cells(dd.cells, keep, dd.distinct, cap=cap)
        dense = dd.cells[dense_rows].to(hll.REGISTER_DTYPE) if slots else None
        return pairs, dense
    pairs = _compact_pairs(dd.cell_s, dd.rank_s, dd.survivor, keep, rows=rows, m=m, cap=cap)
    dense = (
        _materialize_rows(dd.cell_s, dd.rank_s, dd.survivor, slot_of_row, slots=slots, rows=rows, m=m)
        if slots
        else None
    )
    return pairs, dense


def _scatter_pairs_dense(pairs: torch.Tensor, m: int) -> torch.Tensor:
    """(B, C) packed pairs -> (B, m) uint8 registers (one scatter-max)."""
    rows, cap = pairs.shape
    regs = torch.zeros(rows * m, dtype=hll.REGISTER_DTYPE, device=pairs.device)
    if cap:
        valid = pairs >= 0
        row = torch.arange(rows, device=pairs.device)[:, None]
        cell = row * m + torch.where(valid, pairs >> _PACK_SHIFT, 0)
        rank = torch.where(valid, pairs & _PACK_MASK, 0).to(hll.REGISTER_DTYPE)
        regs.scatter_reduce_(0, cell.reshape(-1), rank.reshape(-1), "amax")
    return regs.reshape(rows, m)


def _lc_estimate(sparse_len: torch.Tensor, m: int) -> torch.Tensor:
    """Closed-form LinearCounting over per-row distinct counts.

    The same float32 operations as the small-range branch of the dense
    device finalizer (``estimators._original_device``, and the
    ``hll_estimate`` kernel's on the card), so a sparse row's estimate is
    bit-identical to the dense path's on the card.
    """
    from repro_torch.sketch.estimators import _over

    fm = float(m)
    v = (m - sparse_len).to(torch.float32)
    return fm * torch.log(_over(fm, torch.clamp(v, min=1.0)))


def _settled_triples(pair_buf: torch.Tensor):
    """Live pairs of a settled (B, C) buffer as (row, bucket, rank) int32.

    Only ``sum(pair_len)`` of the B*C slots are live; extracting them keeps
    the dedup's cost proportional to live pairs.  (The reference pads the
    triples to a power of two to bound jit recompiles; eager torch needs
    no padding.)
    """
    rows_, slots = torch.nonzero(pair_buf >= 0, as_tuple=True)
    packed = pair_buf[rows_, slots]
    return rows_.to(torch.int32), packed >> _PACK_SHIFT, packed & _PACK_MASK


def _as_mask(dense_rows, rows: int, device) -> torch.Tensor:
    if dense_rows is None:
        return torch.zeros(rows, dtype=torch.bool, device=device)
    mask = dense_rows
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.asarray(mask, dtype=bool))
    if tuple(mask.shape) != (rows,):
        raise ValueError(f"dense_rows must be a ({rows},) mask, got {tuple(mask.shape)}")
    return mask.to(device=device, dtype=torch.bool)


# ----------------------------------------------------------------------------
# the hybrid carrier
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HybridBank:
    """B same-config sketches, each row sparse (COO pairs) or dense.

    The stored fields are the SETTLED state plus the transient append log;
    external readers should use the ``pairs`` / ``sparse_len`` / ``dense``
    / ``dense_slot`` properties (or any read method), which compact the log
    first -- raw fields are only safe on a bank whose ``pending`` is None.
    """

    pair_buf: torch.Tensor  # (B, C) int32 packed bucket<<8|rank, -1 = empty
    pair_len: torch.Tensor  # (B,) int32 distinct buckets (0 for dense rows)
    dense_block: torch.Tensor  # (D, m) uint8 registers of promoted rows
    slot_map: torch.Tensor  # (B,) int32 slot into dense_block, -1 = sparse
    n_items: torch.Tensor  # (B, 2) int64 (hi, lo) uint32 limbs, exact counts
    cfg: HLLConfig
    threshold: int  # promote when a row's distinct buckets exceed this
    pending: Optional[_PendingLog] = None  # un-deduplicated append log

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def empty(
        cls,
        rows: int,
        cfg: Optional[HLLConfig] = None,
        threshold: Optional[int] = None,
        device=None,
    ) -> "HybridBank":
        cfg = cfg or HLLConfig()
        if rows < 1:
            raise ValueError(f"a bank needs at least one row, got {rows}")
        threshold = _check_threshold(
            default_threshold(cfg) if threshold is None else threshold, cfg
        )
        device = hll.resolve_device(device)
        return cls(
            torch.zeros((rows, 0), dtype=torch.int32, device=device),
            torch.zeros((rows,), dtype=torch.int32, device=device),
            torch.zeros((0, cfg.m), dtype=hll.REGISTER_DTYPE, device=device),
            torch.full((rows,), -1, dtype=torch.int32, device=device),
            torch.zeros((rows, 2), dtype=torch.int64, device=device),
            cfg,
            threshold,
        )

    @classmethod
    def from_dense(
        cls,
        bank: SketchBank,
        threshold: Optional[int] = None,
        dense_rows=None,
    ) -> "HybridBank":
        """Demote a dense bank: rows at or under ``threshold`` distinct
        buckets become sparse unless forced dense via ``dense_rows``."""
        cfg = bank.cfg
        threshold = _check_threshold(
            default_threshold(cfg) if threshold is None else threshold, cfg
        )
        regs = bank.registers
        rows = regs.shape[0]
        occ = (regs > 0).sum(dim=1, dtype=torch.int64)
        dense_mask = _as_mask(dense_rows, rows, regs.device) | (occ > threshold)
        sparse_len = torch.where(dense_mask, 0, occ)
        cap = _fit_capacity(int(sparse_len.max()), threshold)
        pairs = _compact_cells(regs, ~dense_mask, occ, cap=cap)
        dense_idx = torch.nonzero(dense_mask).squeeze(1)
        dense_slot = torch.full((rows,), -1, dtype=torch.int32, device=regs.device)
        dense_slot[dense_idx] = torch.arange(dense_idx.shape[0], dtype=torch.int32, device=regs.device)
        return cls(
            pairs,
            sparse_len.to(torch.int32),
            regs[dense_idx],
            dense_slot,
            bank.n_items,
            cfg,
            threshold,
        )

    @classmethod
    def from_sketches(
        cls,
        sketches: Sequence[HyperLogLog],
        threshold: Optional[int] = None,
    ) -> "HybridBank":
        return cls.from_dense(SketchBank.from_sketches(sketches), threshold)

    # ------------------------------------------------------------------
    # compaction (the append log's one exit; every read routes here)
    # ------------------------------------------------------------------

    @property
    def pending_pairs(self) -> int:
        """Raw (bucket, rank) appends logged since the last compaction."""
        return 0 if self.pending is None else self.pending.total

    def _pending_pressure(self) -> bool:
        """True once the log passes both flush floors (module note)."""
        pend = self.pending
        if pend is None or pend.total < _FLUSH_MIN_PAIRS:
            return False
        live = int(self.pair_len.sum())
        return pend.total >= max(_FLUSH_MIN_PAIRS, _FLUSH_FACTOR * live)

    def compact(self, _reason: str = "read") -> "HybridBank":
        """Settle the append log: dedup, recompact, promote -- one pass.

        Idempotent and cached (a bank is immutable, so its settled form is
        too): repeated reads on the same instance compact once.  The
        result is bit-identical to having eagerly deduplicated every
        ``update_many`` batch.  ``_reason`` labels the flush for the metrics
        registry: "read" for settle-reads (a read surface forcing the log
        down), "pressure" when the ingest path crossed the flush floors.
        """
        if self.pending is None:
            return self
        cached = self.__dict__.get("_settled")
        if cached is None:
            obs_metrics.inc(f"sparse.flush.{_reason}")
            cached = self._compact_now()
            object.__setattr__(self, "_settled", cached)
        return cached

    def _compact_now(self) -> "HybridBank":
        pend = self.pending
        rows, m = len(self), self.cfg.m
        keys = torch.cat([k for k, _ in pend.chunks])
        idx, rank = _hash_stream(torch.cat([v for _, v in pend.chunks]), self.cfg, pend.plan)
        old_rows, old_buckets, old_ranks = _settled_triples(self.pair_buf)
        dd = dedup_pairs(
            torch.cat([old_rows, keys]),
            torch.cat([old_buckets, idx]),
            torch.cat([old_ranks, rank]),
            rows,
            self.cfg,
            pend.plan,
        )
        was_sparse = self.slot_map < 0
        promote = was_sparse & (dd.distinct > self.threshold)
        keep = was_sparse & ~promote
        pair_len = torch.where(keep, dd.distinct, 0)
        cap = _fit_capacity(int(pair_len.max()), self.threshold)
        promoted = torch.nonzero(promote).squeeze(1)
        count = int(promoted.shape[0])
        if count:
            obs_metrics.inc("sparse.promotions", count)
        slot_of_row = torch.full((rows,), -1, dtype=torch.int32, device=keys.device)
        slot_of_row[promoted] = torch.arange(count, dtype=torch.int32, device=keys.device)
        new_pairs, fresh = _dedup_products(
            dd, keep, slot_of_row, promoted, rows=rows, m=m, cap=cap
        )
        new_dense, new_slot = self.dense_block, self.slot_map
        if count:
            new_dense = torch.cat([new_dense, fresh])
            new_slot = new_slot.clone()
            new_slot[promoted] = self.dense_block.shape[0] + torch.arange(
                count, dtype=torch.int32, device=keys.device
            )
        return dataclasses.replace(
            self,
            pair_buf=new_pairs,
            pair_len=pair_len.to(torch.int32),
            dense_block=new_dense,
            slot_map=new_slot,
            pending=None,
        )

    # ------------------------------------------------------------------
    # introspection (every surface reads the SETTLED state)
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return int(self.n_items.shape[0])

    @property
    def device(self) -> torch.device:
        return self.n_items.device

    @property
    def pairs(self) -> torch.Tensor:
        """(B, C) packed pair buffer of the settled state."""
        return self.compact().pair_buf

    @property
    def sparse_len(self) -> torch.Tensor:
        """(B,) int32 distinct-bucket counts of the settled state."""
        return self.compact().pair_len

    @property
    def dense(self) -> torch.Tensor:
        """(D, m) uint8 dense block of the settled state."""
        return self.compact().dense_block

    @property
    def dense_slot(self) -> torch.Tensor:
        """(B,) int32 row -> dense slot map of the settled state."""
        return self.compact().slot_map

    @property
    def capacity(self) -> int:
        """Current per-row sparse pair capacity C."""
        return int(self.compact().pair_buf.shape[1])

    @property
    def dense_rows(self) -> int:
        """Number of promoted rows (the D of the dense block)."""
        return int(self.compact().dense_block.shape[0])

    @property
    def modes(self) -> np.ndarray:
        """(B,) uint8 row modes: MODE_SPARSE (0) or MODE_DENSE (1)."""
        return (self.compact().slot_map >= 0).cpu().numpy().astype(np.uint8)

    @property
    def counts(self) -> np.ndarray:
        """(B,) exact per-row observation counts as uint64 (updated eagerly
        at ingest, so they never wait on a compaction)."""
        return u64.to_numpy(self.n_items)

    @property
    def nbytes(self) -> int:
        """Storage footprint of the settled hybrid representation, in the
        reference's layout (int32 pairs, lengths and slots, uint8 dense
        block, uint32 counter limbs), so both packages report one size."""
        s = self.compact()
        rows = len(s)
        return int(4 * s.pair_buf.numel() + 4 * rows + s.dense_block.numel() + 4 * rows + 8 * rows)

    def density(self) -> dict:
        """Storage introspection: modes, occupancy, and the memory win."""
        s = self.compact()
        rows = len(s)
        m = s.cfg.m
        d = int(s.dense_block.shape[0])
        occ = s.pair_len.to(torch.int64)
        if d:
            dense_occ = (s.dense_block > 0).sum(dim=1, dtype=torch.int64)
            occ = torch.where(s.slot_map >= 0, dense_occ[torch.clamp(s.slot_map, 0, d - 1)], occ)
        occ = occ.cpu().numpy()
        dense_nbytes = rows * m + rows * 8  # what a SketchBank would cost
        return {
            "rows": rows,
            "dense_rows": d,
            "sparse_rows": rows - d,
            "capacity": int(s.pair_buf.shape[1]),
            "threshold": s.threshold,
            "occupancy_mean": float(occ.mean() / m) if rows else 0.0,
            "nbytes": s.nbytes,
            "dense_nbytes": dense_nbytes,
            "reduction": dense_nbytes / s.nbytes if s.nbytes else 0.0,
        }

    def row(self, i: int) -> HyperLogLog:
        """Row ``i`` materialized as a standalone dense carrier."""
        rows = len(self)
        if not -rows <= i < rows:
            raise IndexError(f"row {i} out of range for a {rows}-row bank")
        i = i % rows
        s = self.compact()
        slot = int(s.slot_map[i])
        if slot >= 0:
            regs = s.dense_block[slot]
        else:
            regs = _scatter_pairs_dense(s.pair_buf[i : i + 1], s.cfg.m)[0]
        return HyperLogLog(regs, s.n_items[i], s.cfg)

    # ------------------------------------------------------------------
    # conversion
    # ------------------------------------------------------------------

    def _dense_registers(self) -> torch.Tensor:
        """The settled bank materialized as (B, m) uint8 registers."""
        s = self.compact()
        regs = _scatter_pairs_dense(s.pair_buf, s.cfg.m)
        d = int(s.dense_block.shape[0])
        if d:
            slot = torch.clamp(s.slot_map, 0, d - 1)
            regs = torch.where((s.slot_map >= 0)[:, None], s.dense_block[slot], regs)
        return regs

    def to_dense(self) -> SketchBank:
        """Materialize to a plain dense ``SketchBank`` (lossless)."""
        return SketchBank(self._dense_registers(), self.n_items, self.cfg)

    def to_sketches(self) -> list:
        return [self.row(i) for i in range(len(self))]

    # ------------------------------------------------------------------
    # aggregation (paper phase 3, hybrid-routed)
    # ------------------------------------------------------------------

    def update_many(self, keys, items, plan: Optional[ExecutionPlan] = None) -> "HybridBank":
        """Route each item to row ``keys[i]``'s current representation.

        Routing runs on the bank's device: the dense-destined sub-stream
        dispatches through the bank backend registered under
        ``plan.backend`` (§9) at once -- its keys remapped to dense slots,
        every other key sent to -1, which the backend drops -- and the
        sparse-destined sub-stream APPENDS to the log, compacting here only
        if the log passes the pressure floors.  The host reads back two
        counts (how many items go each way), never the stream.  Zero-length
        streams return ``self`` without dispatching any backend.
        """
        flat_keys, flat_items = _flat_keys_items(keys, items, self.device)
        rows = len(self)
        n = flat_items.shape[0]
        if n == 0 or rows == 0:
            return self
        _check_cell_space(rows, self.cfg.m)
        plan = (DEFAULT_PLAN if plan is None else plan).validate()
        valid = (flat_keys >= 0) & (flat_keys < rows)
        dest = torch.where(valid, self.slot_map[torch.clamp(flat_keys, 0, rows - 1).to(torch.int64)], -1)
        dense_sel = dest >= 0
        sparse_sel = valid & ~dense_sel
        n_dense, n_sparse = (int(v) for v in torch.stack([dense_sel.sum(), sparse_sel.sum()]).tolist())

        new_dense = self.dense_block
        if n_dense:
            new_dense = update_bank_registers(self.dense_block, dest, flat_items, self.cfg, plan)

        pending = self.pending
        if n_sparse:
            chunk = (flat_keys, flat_items)
            if n_sparse < n:
                chunk = (flat_keys[sparse_sel], flat_items[sparse_sel])
            chunks = (chunk,) if pending is None else pending.chunks + (chunk,)
            pending = _PendingLog(chunks, n_sparse + (pending.total if pending else 0), plan)
            obs_metrics.inc("sparse.pending.appends")
            obs_metrics.inc("sparse.pending.pairs", n_sparse)

        out = dataclasses.replace(
            self,
            dense_block=new_dense,
            n_items=bank_row_count(self.n_items, flat_keys),
            pending=pending,
        )
        if out._pending_pressure():
            return out.compact(_reason="pressure")
        return out

    def merge(self, other: "HybridBank", plan: Optional[ExecutionPlan] = None) -> "HybridBank":
        """Row-wise Merge-buckets fold; dense mode is infectious.

        Both sides settle first, then both sides' live sparse pairs dedup
        through ``dedup_pairs`` under ``plan``; rows staying sparse
        recompact, and only the dense result rows (dense on either side, or
        a sparse union crossing the threshold) materialize registers,
        overlaid with each side's dense blocks.
        """
        if self.cfg != other.cfg:
            raise ValueError(
                f"cannot merge banks with different configs: "
                f"{self.cfg} vs {other.cfg}"
            )
        if len(self) != len(other):
            raise ValueError(
                f"cannot merge banks of different sizes: "
                f"{len(self)} vs {len(other)} rows"
            )
        if self.threshold != other.threshold:
            raise ValueError(
                f"cannot merge banks with different sparse thresholds: "
                f"{self.threshold} vs {other.threshold}"
            )
        a, b = self.compact(), other.compact()
        rows, m = len(a), a.cfg.m
        n_items = u64.add(a.n_items, b.n_items)
        _check_cell_space(rows, m)
        plan = (DEFAULT_PLAN if plan is None else plan).validate()
        force_dense = (a.slot_map >= 0) | (b.slot_map >= 0)
        # a row dense on one side still contributes the OTHER side's pairs
        # through the triple stream; its dense registers overlay below
        ra, ba, ka = _settled_triples(a.pair_buf)
        rb, bb, kb = _settled_triples(b.pair_buf)
        dd = dedup_pairs(
            torch.cat([ra, rb]), torch.cat([ba, bb]), torch.cat([ka, kb]), rows, a.cfg, plan
        )
        promote = ~force_dense & (dd.distinct > a.threshold)
        keep = ~force_dense & ~promote
        pair_len = torch.where(keep, dd.distinct, 0)
        cap = _fit_capacity(int(pair_len.max()), a.threshold)
        dense_idx = torch.nonzero(force_dense | promote).squeeze(1)
        count = int(dense_idx.shape[0])
        slot_of_row = torch.full((rows,), -1, dtype=torch.int32, device=a.device)
        slot_of_row[dense_idx] = torch.arange(count, dtype=torch.int32, device=a.device)
        pairs, dense = _dedup_products(dd, keep, slot_of_row, dense_idx, rows=rows, m=m, cap=cap)
        if count:
            for side in (a, b):
                d = int(side.dense_block.shape[0])
                if d:
                    sel = side.slot_map[dense_idx]
                    contrib = torch.where(
                        (sel >= 0)[:, None], side.dense_block[torch.clamp(sel, 0, d - 1)], 0
                    )
                    dense = torch.maximum(dense, contrib)
        else:
            dense = torch.zeros((0, m), dtype=hll.REGISTER_DTYPE, device=a.device)
        return dataclasses.replace(
            a,
            pair_buf=pairs,
            pair_len=pair_len.to(torch.int32),
            dense_block=dense,
            slot_map=slot_of_row,
            n_items=n_items,
        )

    __or__ = merge

    # ------------------------------------------------------------------
    # estimation (paper phase 4, sparse-aware)
    # ------------------------------------------------------------------

    def _sparse_histograms(self) -> torch.Tensor:
        """(B, K) int32 histograms straight from the settled pairs
        (C[0] = m - len)."""
        from repro_torch.sketch import estimators as _estimators

        s = self.compact()
        rows, cap = s.pair_buf.shape
        k = _estimators.histogram_size(s.cfg)
        counts = torch.zeros((rows, k), dtype=torch.int32, device=s.device)
        if cap:
            valid = s.pair_buf >= 0
            row = torch.arange(rows, device=s.device)[:, None]
            idx = torch.where(valid, row * k + (s.pair_buf & _PACK_MASK), rows * k)
            counts = torch.bincount(idx.reshape(-1), minlength=rows * k + 1)[: rows * k]
            counts = counts.reshape(rows, k).to(torch.int32)
        counts[:, 0] = s.cfg.m - s.pair_len
        return counts

    def estimate_many(
        self,
        estimator: Optional[str] = None,
        *,
        lc_fast: bool = True,
        plan: Optional[ExecutionPlan] = None,
    ) -> torch.Tensor:
        """(B,) float32 estimates, sparse rows via the LC fast path.

        For the default ``original`` estimator, sparse rows finalize with
        the closed-form LinearCounting read; other estimators (or
        ``lc_fast=False``) build histograms from the pairs and run the
        registered device finalizer.  Dense rows finalize through the §8
        batched ``estimate_many``, per row block under a
        placement="sharded" ``plan`` (§16); the sparse side is COO math
        with no row axis on the device, so placement cannot move it.
        """
        from repro_torch.sketch import estimators as _estimators

        s = self.compact()
        if len(s) == 0:
            return torch.zeros((0,), dtype=torch.float32, device=s.device)
        name = _estimators.resolve_estimator(
            estimator or (plan.validate().estimator if plan is not None else None)
        )
        if name == "original" and lc_fast:
            sparse_est = _lc_estimate(s.pair_len, s.cfg.m)
        else:
            hist = s._sparse_histograms().to(torch.float32)
            sparse_est = _estimators.get_estimator(name).device(hist, s.cfg)
        d = int(s.dense_block.shape[0])
        if d:
            dense_est = estimate_rows(s.dense_block, s.cfg, name, plan)
            slot = torch.clamp(s.slot_map, 0, d - 1)
            return torch.where(s.slot_map >= 0, dense_est[slot], sparse_est)
        return sparse_est

    def estimate(self, i: int, estimator: Optional[str] = None) -> float:
        """Exact host-side estimate of one row."""
        return self.row(i).estimate(estimator)

    # ------------------------------------------------------------------
    # serialization (RHLB v2: per-row mode flags + sparse payloads)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """RHLB v2: header + threshold + counts + mode flags + payloads.

        Always serializes the SETTLED state -- the log compacts first.
        """
        s = self.compact()
        rows = len(s)
        header = _BANK_HEADER.pack(
            _BANK_MAGIC, _SPARSE_VERSION, s.cfg.p, s.cfg.hash_bits, 0, s.cfg.seed, rows
        )
        out = [header, _THRESHOLD.pack(s.threshold)]
        out.append(s.counts.astype("<u8").tobytes())
        slot_np = s.slot_map.cpu().numpy()
        modes = (slot_np >= 0).astype(np.uint8)
        out.append(modes.tobytes())
        pairs_np = s.pair_buf.cpu().numpy()
        dense_np = s.dense_block.cpu().numpy().astype(np.uint8)
        for i in range(rows):
            if modes[i] == MODE_DENSE:
                out.append(dense_np[slot_np[i]].tobytes())
            else:
                p = pairs_np[i]
                p = p[p >= 0]
                out.append(_NPAIRS.pack(p.size))
                pair_bytes = np.zeros((p.size, 3), np.uint8)
                pair_bytes[:, :2] = (p >> _PACK_SHIFT).astype("<u2").view(np.uint8).reshape(-1, 2)
                pair_bytes[:, 2] = p & _PACK_MASK
                out.append(pair_bytes.tobytes())
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "HybridBank":
        """Parse RHLB v2 strictly; v1 dense blobs parse as all-dense."""
        if len(data) < _BANK_HEADER.size:
            raise ValueError(f"truncated bank: {len(data)} bytes")
        magic, version, p, hash_bits, _flags, seed, rows = _BANK_HEADER.unpack(
            data[: _BANK_HEADER.size]
        )
        if magic != _BANK_MAGIC:
            raise ValueError(f"bad magic {magic!r}; not a serialized bank")
        if version == 1:
            # dense blobs still parse, version-gated: every row stays dense
            bank = SketchBank.from_bytes(data, device)
            return cls.from_dense(bank, dense_rows=np.ones(len(bank), bool))
        if version != _SPARSE_VERSION:
            raise ValueError(f"unsupported bank version {version}")
        if rows < 1:
            raise ValueError(f"bank header claims {rows} rows")
        cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
        off = _BANK_HEADER.size
        if len(data) < off + _THRESHOLD.size:
            raise ValueError("truncated bank: threshold missing")
        (threshold,) = _THRESHOLD.unpack_from(data, off)
        threshold = _check_threshold(threshold, cfg)
        off += _THRESHOLD.size
        counts_end = off + rows * _ROW_COUNT.size
        modes_end = counts_end + rows
        if len(data) < modes_end:
            raise ValueError("truncated bank: counts/mode flags cut short")
        raw_counts = np.frombuffer(data[off:counts_end], dtype="<u8")
        modes = np.frombuffer(data[counts_end:modes_end], dtype=np.uint8)
        if not np.isin(modes, (MODE_SPARSE, MODE_DENSE)).all():
            raise ValueError(
                f"corrupt mode flag {int(modes.max())}; rows are sparse (0) "
                f"or dense (1)"
            )
        off = modes_end
        sparse_pairs, dense_regs = [], []
        for i in range(rows):
            if modes[i] == MODE_DENSE:
                if len(data) < off + cfg.m:
                    raise ValueError(f"row {i}: dense payload cut short")
                dense_regs.append(np.frombuffer(data[off : off + cfg.m], np.uint8))
                off += cfg.m
                continue
            if len(data) < off + _NPAIRS.size:
                raise ValueError(f"row {i}: pair count cut short")
            (npairs,) = _NPAIRS.unpack_from(data, off)
            off += _NPAIRS.size
            if npairs > threshold:
                raise ValueError(f"row {i}: {npairs} pairs exceeds threshold {threshold}")
            end = off + npairs * 3
            if len(data) < end:
                raise ValueError(f"row {i}: pair list cut short")
            raw = np.frombuffer(data[off:end], np.uint8).reshape(npairs, 3)
            buckets = raw[:, :2].copy().view("<u2").reshape(-1).astype(np.int64)
            ranks = raw[:, 2].astype(np.int64)
            if npairs:
                if buckets.max() >= cfg.m:
                    raise ValueError(
                        f"row {i}: bucket {int(buckets.max())} out of range "
                        f"for m={cfg.m}"
                    )
                if not (np.diff(buckets) > 0).all():
                    raise ValueError(f"row {i}: pair buckets must be strictly increasing")
                if ranks.min() < 1 or ranks.max() > cfg.max_rank:
                    raise ValueError(f"row {i}: rank outside [1, {cfg.max_rank}]")
            sparse_pairs.append(((buckets << _PACK_SHIFT) | ranks).astype(np.int32))
            off = end
        if off != len(data):
            raise ValueError(f"bank payload is {len(data)} bytes, expected {off}")
        cap = _fit_capacity(max((q.size for q in sparse_pairs), default=0), threshold)
        pairs = np.full((rows, cap), _EMPTY, np.int32)
        sparse_len = np.zeros(rows, np.int32)
        dense_slot = np.full(rows, -1, np.int32)
        # dense slots in row order (matching to_bytes)
        d = s = 0
        for i in range(rows):
            if modes[i] == MODE_DENSE:
                dense_slot[i] = d
                d += 1
            else:
                pr = sparse_pairs[s]
                pairs[i, : pr.size] = pr
                sparse_len[i] = pr.size
                s += 1
        dense = np.stack(dense_regs) if dense_regs else np.zeros((0, cfg.m), np.uint8)
        device = hll.resolve_device(device)
        return cls(
            torch.from_numpy(pairs).to(device),
            torch.from_numpy(sparse_len).to(device),
            torch.from_numpy(dense).to(device),
            torch.from_numpy(dense_slot).to(device),
            u64.from_numpy(raw_counts, device),
            cfg,
            threshold,
        )


# ----------------------------------------------------------------------------
# module-level entry point (mirrors bank.update_many)
# ----------------------------------------------------------------------------


def update_many(bank: HybridBank, keys, items, plan: Optional[ExecutionPlan] = None) -> HybridBank:
    """Batched hybrid ingestion: sparse/dense routing in one fused pass."""
    return bank.update_many(keys, items, plan)
