"""CountMinBank: heavy-hitter (frequency) sketches on the registry spine.

Port of ``repro/sketch/countmin.py``.  A ``CountMinBank`` carries B
per-tenant count-min sketches -- a (B, d, w) counter bank plus a
Topkapi-style (B, d, w) label table and its votes -- and every verb
dispatches through the same ``ExecutionPlan`` registries as the HLL family
(DESIGN.md §13).

Count-min core (Cormode & Muthukrishnan): each item increments one cell per
depth row, at the column picked by an independent hash; a point query reads
the d cells back and takes the min (an upper bound on the true count).  The
d hashes derive from ONE murmur3_64 evaluation by Kirsch-Mitzenmacher double
hashing, ``idx_r = (h.lo + r * h.hi) mod w`` in uint32.

Top-k recovery follows Topkapi: each cell carries a (label, label_count)
majority-vote pair, and the heavy hitters are recovered by querying the
surviving labels.  ``update_many`` applies the reference's BATCH-CANONICAL
vote: a pure function of the batch multiset, so label state is
bit-identical under every backend.  The vote does not depend on the
backend: on the card it is the hand-written ``cm_vote`` kernel (a sort-free
election by cell, no read to the host), and on the CPU its plain PyTorch
version ``_label_update``, which the tests hold the kernel to.  Backends
differ only on the counter scatter (the ``cm_scatter_add`` kernel under
"cuda").

Counters are uint32 in the reference and wrap mod 2^32.  PyTorch has almost
no ``torch.uint32`` arithmetic, so here they are int32 tensors holding the
uint32 bits: int32 adds wrap to the same bits.  Every place that orders or
compares counters (the query's min over d, ``topk``'s ranking) reads them as
unsigned, ``x & 0xFFFFFFFF`` in int64, and a point query returns the uint32
values in int64.  The wire formats (RCMB, RCMW) and ``interop`` carry them
as uint32, byte-identical to the reference's.

Key routing, drop rules, exact per-row observation counters and the
zero-length/zero-row short circuits mirror ``SketchBank`` (DESIGN.md §9);
``WindowedCountMinBank`` rides the epoch-ring contract of ``WindowedBank``
(DESIGN.md §11) with a masked SUM fold.  Entry points run on the card unless
the caller asks for the CPU (``device=None`` means ``torch.device("cuda")``).
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.bank_count import bank_row_count
from repro_torch.kernels.cm_vote import cm_vote
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing
from repro_torch.sketch import hll, murmur3, u64
from repro_torch.sketch.bank import _flat_keys_items
from repro_torch.sketch.dispatch import cm_mesh_sum
from repro_torch.sketch.plan import (
    DEFAULT_PLAN,
    ExecutionPlan,
    get_cm_backend,
    get_cm_window_backend,
)
from repro_torch.sketch.window import (
    _EPOCH,
    _RingReads,
    _ring_epochs,
    _to_device,
    _validate_epoch_ring,
)

COUNTER_DTYPE = torch.int32  # the reference's uint32 counters, as their bits
LABEL_DTYPE = torch.int32

_CM_HEADER = struct.Struct("<4sBBHQII")  # magic, ver, depth, flags, seed, w, B
_CM_MAGIC = b"RCMB"
_CM_VERSION = 1
_ROW_COUNT = struct.Struct("<Q")

_CMW_HEADER = struct.Struct("<4sBBHQIIII")
# magic, ver, depth, flags, seed, width, W, B, cursor
_CMW_MAGIC = b"RCMW"
_CMW_VERSION = 1

_INT32_MIN = -(1 << 31)


@dataclasses.dataclass(frozen=True)
class CMConfig:
    """Static count-min parameters: d depth rows x w counters per row.

    A point query overestimates by at most ``2n/w`` with probability
    ``1 - 2^-d`` (n = stream length), so width buys accuracy and depth buys
    confidence.  ``seed`` feeds the single murmur3_64 evaluation both
    derived hash families share.
    """

    depth: int = 4
    width: int = 1024
    seed: int = 0

    def __post_init__(self):
        if not 1 <= self.depth <= 16:
            raise ValueError(f"depth must be in [1,16], got {self.depth}")
        if not 1 <= self.width <= 1 << 24:
            raise ValueError(f"width must be in [1, 2^24], got {self.width}")
        if not 0 <= self.seed < 1 << 64:
            # keeps the serialized header (uint64 seed) total, like HLLConfig
            raise ValueError(f"seed must be a uint64, got {self.seed}")

    @property
    def cells(self) -> int:
        return self.depth * self.width

    @property
    def memory_footprint_bits(self) -> int:
        # counter + label + label_count, all 32-bit, per cell
        return self.cells * 3 * 32


def cm_hash_index(items: torch.Tensor, cfg: CMConfig) -> torch.Tensor:
    """The d column indices of each item: (d, n) int32 in [0, w).

    Kirsch-Mitzenmacher double hashing over the two uint32 limbs of one
    murmur3_64 evaluation, ``idx_r = (h.lo + r * h.hi) mod w``: the sum
    wraps mod 2^32 as the reference's uint32 does, and the ``mod w`` is
    taken on that unsigned value (in int64, where it is non-negative).
    """
    h = murmur3.murmur3_64(items.reshape(-1), cfg.seed)
    lo = h & u64.MASK32
    hi = u64.shr(h, 32)
    r = torch.arange(cfg.depth, dtype=torch.int64, device=h.device)[:, None]
    mixed = (lo[None, :] + r * hi[None, :]) & u64.MASK32
    return (mixed % cfg.width).to(torch.int32)


def unsigned(counters: torch.Tensor) -> torch.Tensor:
    """int32-held uint32 counters -> their unsigned values in int64."""
    return counters.to(torch.int64) & u64.MASK32


# ----------------------------------------------------------------------------
# functional dispatch (mirrors bank.update_bank_registers)
# ----------------------------------------------------------------------------


def update_cm_counters(
    counters: torch.Tensor,
    keys,
    items,
    cfg: CMConfig,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """Keyed scatter-add of ``items`` into a raw (B, d, w) int32 counter bank.

    The cm-capable backend registered under ``plan.backend`` runs the fused
    ingest; placement="mesh" (and "sharded", which has no row rule for
    additive state) shards the (keys, items) pair through
    :func:`repro_torch.sketch.dispatch.cm_mesh_sum` (per-shard zero-based
    deltas, keys padded with -1, one wrapping sum).
    """
    plan = (DEFAULT_PLAN if plan is None else plan).validate()
    backend = get_cm_backend(plan.backend)
    flat_keys, flat_items = _flat_keys_items(keys, items, counters.device)
    if flat_items.shape[0] == 0 or counters.shape[0] == 0:
        # nothing to land (or nowhere to land it): no backend dispatch
        return counters
    if plan.placement == "local":
        return backend.ingest(counters, flat_keys, flat_items, cfg, plan)
    return cm_mesh_sum(
        plan,
        counters,
        (flat_keys, flat_items),
        lambda cnt, ks, xs: backend.ingest(cnt, ks, xs, cfg, plan),
    )


def query_cm_counters(
    counters: torch.Tensor,
    items,
    cfg: CMConfig,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """(B, n) int64 point-query estimates of ``items`` against every row.

    Queries read replicated counter state, so mesh plans query locally.
    Zero-length probes and zero-row banks short-circuit without dispatching
    any backend.
    """
    plan = (DEFAULT_PLAN if plan is None else plan).validate()
    backend = get_cm_backend(plan.backend)
    flat = hll.as_items(items, counters.device)
    rows = counters.shape[0]
    if rows == 0 or flat.shape[0] == 0:
        return torch.zeros((rows, flat.shape[0]), dtype=torch.int64, device=counters.device)
    return backend.query(counters, flat, cfg, plan)


# ----------------------------------------------------------------------------
# Topkapi label voting (shared torch routine -- every backend bit-identical)
# ----------------------------------------------------------------------------


def _merge_label_tables(l1, c1, l2, c2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Topkapi cell merge: same labels add, differing labels fight.

    Same label -> counts add.  Different labels -> the bigger count wins and
    keeps the difference; an exact tie keeps the larger label value with
    count 0 (deterministic and symmetric, so ``a | b == b | a``).
    """
    same = l1 == l2
    lab_diff = torch.where(c1 > c2, l1, torch.where(c2 > c1, l2, torch.maximum(l1, l2)))
    label = torch.where(same, l1, lab_diff)
    count = torch.where(same, c1 + c2, torch.abs(c1 - c2))
    return label, count


def _segment_max(values: torch.Tensor, segments: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.ops.segment_max``: per-segment max, int32.min where empty."""
    out = torch.full((num,), _INT32_MIN, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, segments, values, "amax", include_self=False)


def _label_update(
    labels: torch.Tensor,
    label_counts: torch.Tensor,
    keys: torch.Tensor,
    items: torch.Tensor,
    cfg: CMConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch-canonical Topkapi vote over every touched cell: the plain
    PyTorch version, on any device.

    ``update_many`` votes through ``kernels.cm_vote``, which runs this for
    CPU tensors and, for CUDA tensors, the hand-written kernel
    ``csrc/cm_vote.cu`` in its place: the same tables, bit for bit, with
    no sort and no read to the host.

    Per cell, over THIS batch: the winner ``x*`` is the item with the
    highest multiplicity ``mc`` among the batch's hits (ties to the larger
    item value) and its surplus is ``s = 2*mc - total``.  The stored
    (l, lc) pair then absorbs (x*, s):

      lc == 0      -> the cell is vacant: (x*, max(s, 0))
      x* == l      -> votes reinforce:    (l, max(lc + s, 0))
      otherwise    -> t = s - lc decides: t > 0 -> (x*, t)
                                          t < 0 -> (l, -t)
                                          t == 0 -> (max(l, x*), 0)

    Cells with no valid hits this batch are untouched.  The reference's
    ``lexsort((vals, cell))`` is one ``torch.sort`` of the int64 key
    ``cell << 32 | (val + 2^31)``; its run lengths come from
    ``unique_consecutive`` and its ``segment_max`` calls from
    ``scatter_reduce`` amax over B*d*w + 1 segments.
    """
    rows, depth, width = labels.shape
    cells = depth * width
    total_cells = rows * cells
    idx = cm_hash_index(items, cfg).to(torch.int64)  # (d, n)
    valid = (keys >= 0) & (keys < rows)
    lane = torch.arange(depth, dtype=torch.int64, device=idx.device)[:, None] * width
    cell = torch.where(valid[None, :], keys[None, :].to(torch.int64) * cells + lane + idx, total_cells)
    vals = items.to(torch.int64).expand(depth, -1)

    # per-(cell, value) multiplicity via one sort + run-length count
    key, _ = torch.sort(((cell << 32) | (vals + (1 << 31))).reshape(-1))
    sc = key >> 32
    sv = ((key & u64.MASK32) - (1 << 31)).to(torch.int32)
    _, run, run_len = torch.unique_consecutive(key, return_inverse=True, return_counts=True)
    pc = run_len[run]  # multiplicity of each element's (cell, value) pair

    live = sc < total_cells
    total = torch.bincount(sc, minlength=total_cells + 1)[:total_cells].to(torch.int32)
    mc_f = _segment_max(torch.where(live, pc, _INT32_MIN), sc, total_cells + 1)
    is_best = live & (pc == mc_f[sc])
    winner = _segment_max(torch.where(is_best, sv, _INT32_MIN), sc, total_cells + 1)[:total_cells]
    mc = torch.clamp(mc_f[:total_cells], min=0).to(torch.int32)

    s = 2 * mc - total
    l = labels.reshape(total_cells)
    lc = label_counts.reshape(total_cells)
    vacant = lc == 0
    same = winner == l
    t = s - lc
    new_l = torch.where(
        vacant,
        winner,
        torch.where(
            same,
            l,
            torch.where(t > 0, winner, torch.where(t < 0, l, torch.maximum(l, winner))),
        ),
    )
    new_c = torch.where(
        vacant,
        torch.clamp(s, min=0),
        torch.where(same, torch.clamp(lc + s, min=0), torch.abs(t)),
    )
    touched = total > 0
    out_l = torch.where(touched, new_l, l).reshape(rows, depth, width)
    out_c = torch.where(touched, new_c, lc).reshape(rows, depth, width)
    return out_l, out_c


def _query_rowwise(counters: torch.Tensor, cand: torch.Tensor, cfg: CMConfig) -> torch.Tensor:
    """Estimate (B, C) per-row candidates against their OWN rows only (int64)."""
    rows, depth, _ = counters.shape
    n_cand = cand.shape[1]
    idx = cm_hash_index(cand.reshape(-1), cfg).to(torch.int64).reshape(depth, rows, n_cand)
    b = torch.arange(rows, device=counters.device)[:, None, None]
    r = torch.arange(depth, device=counters.device)[None, :, None]
    gathered = counters[b, r, idx.permute(1, 0, 2)]  # (B, d, C)
    return unsigned(gathered).amin(dim=1)


def _rank_topk(cand: torch.Tensor, ests: torch.Tensor, k: int):
    """Per-row top-k distinct candidates by (estimate desc, value desc).

    The reference runs ``np.unique`` and ``np.lexsort`` row by row on the
    host; here two sorts on the bank's device rank every row at once: sort
    each row's candidates, mark the first of each run of equal values, flip
    to descending values, and stable-sort by (distinct, estimate)
    descending, so ties keep the larger value first.  Returns (values,
    estimates, distinct) of the k leading positions.
    """
    s_vals, order = torch.sort(cand, dim=1)
    s_est = ests.gather(1, order)
    first = torch.ones_like(s_vals, dtype=torch.bool)
    first[:, 1:] = s_vals[:, 1:] != s_vals[:, :-1]
    s_vals, s_est, first = s_vals.flip(1), s_est.flip(1), first.flip(1)
    rank_key = (first.to(torch.int64) << 33) | s_est
    top = torch.sort(rank_key, dim=1, descending=True, stable=True).indices[:, :k]
    return s_vals.gather(1, top), s_est.gather(1, top), first.gather(1, top)


# ----------------------------------------------------------------------------
# the carrier
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CountMinBank:
    """B same-config count-min sketches (+ Topkapi labels) as one value."""

    counters: torch.Tensor  # (B, d, w) int32 holding uint32 bits
    labels: torch.Tensor  # (B, d, w) int32 Topkapi majority labels
    label_counts: torch.Tensor  # (B, d, w) int32 majority-vote counts
    n_items: torch.Tensor  # (B, 2) int64 (hi, lo) uint32 limbs, exact per-row counts
    cfg: CMConfig

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def empty(cls, rows: int, cfg: Optional[CMConfig] = None, device=None) -> "CountMinBank":
        cfg = cfg or CMConfig()
        if rows < 1:
            raise ValueError(f"a bank needs at least one row, got {rows}")
        device = hll.resolve_device(device)
        shape = (rows, cfg.depth, cfg.width)
        return cls(
            torch.zeros(shape, dtype=COUNTER_DTYPE, device=device),
            torch.zeros(shape, dtype=LABEL_DTYPE, device=device),
            torch.zeros(shape, dtype=LABEL_DTYPE, device=device),
            torch.zeros((rows, 2), dtype=torch.int64, device=device),
            cfg,
        )

    def with_rows(self, rows: int) -> "CountMinBank":
        """Grow the bank axis to ``rows`` (new rows start empty)."""
        have = len(self)
        if rows < have:
            raise ValueError(f"cannot shrink a {have}-row bank to {rows}")
        if rows == have:
            return self
        grow = (0, 0, 0, 0, 0, rows - have)
        pad = torch.nn.functional.pad
        return dataclasses.replace(
            self,
            counters=pad(self.counters, grow),
            labels=pad(self.labels, grow),
            label_counts=pad(self.label_counts, grow),
            n_items=pad(self.n_items, (0, 0, 0, rows - have)),
        )

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return int(self.counters.shape[0])

    @property
    def device(self) -> torch.device:
        return self.counters.device

    @property
    def counts(self) -> np.ndarray:
        """(B,) exact per-row observation counts as uint64."""
        return u64.to_numpy(self.n_items)

    @property
    def nbytes(self) -> int:
        """Footprint in the reference's layout (three 32-bit tables and
        uint32 counter limbs, 8 B per row), so both packages agree."""
        return int(3 * 4 * self.counters.numel() + 8 * len(self))

    # ------------------------------------------------------------------
    # aggregation (paper phase 3, frequency flavor)
    # ------------------------------------------------------------------

    def update_many(self, keys, items, plan: Optional[ExecutionPlan] = None) -> "CountMinBank":
        """Route each item to row ``keys[i]``: one fused d-hash scatter-add.

        Counters go through the cm backend registered under
        ``plan.backend``; the Topkapi label vote is ``cm_vote`` on the full
        stream under every backend (the kernel on the card, ``_label_update``
        on the CPU), so label state cannot drift across backends.  A
        zero-length stream or a zero-row bank returns ``self`` without
        dispatching anything.
        """
        flat_keys, flat_items = _flat_keys_items(keys, items, self.device)
        if flat_items.shape[0] == 0 or len(self) == 0:
            return self
        with tracing.region("sketch.cm.update_many"):
            obs_metrics.observe("cm.update_many.batch_items", flat_items.shape[0])
            with tracing.region("sketch.cm.scatter"):
                counters = update_cm_counters(self.counters, flat_keys, flat_items, self.cfg, plan)
            with tracing.region("sketch.cm.vote"):
                labels, label_counts = cm_vote(self.labels, self.label_counts, flat_keys, flat_items, self.cfg)
            with tracing.region("sketch.cm.counters"):
                n_items = bank_row_count(self.n_items, flat_keys)
            return dataclasses.replace(
                self,
                counters=counters,
                labels=labels,
                label_counts=label_counts,
                n_items=n_items,
            )

    def merge(self, other: "CountMinBank") -> "CountMinBank":
        """Cell-wise counter sum (mod 2^32) + Topkapi label merge; the exact
        observation counters add to 2^64."""
        if self.cfg != other.cfg:
            raise ValueError(
                f"cannot merge banks with different configs: {self.cfg} vs {other.cfg}"
            )
        if len(self) != len(other):
            raise ValueError(
                f"cannot merge banks of different sizes: {len(self)} vs {len(other)} rows"
            )
        labels, label_counts = _merge_label_tables(
            self.labels, self.label_counts, other.labels, other.label_counts
        )
        return dataclasses.replace(
            self,
            counters=self.counters + other.counters,
            labels=labels,
            label_counts=label_counts,
            n_items=u64.add(self.n_items, other.n_items),
        )

    __or__ = merge

    # ------------------------------------------------------------------
    # queries (paper phase 4, frequency flavor)
    # ------------------------------------------------------------------

    def query(self, items, plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
        """(B, n) int64 estimated counts of each probe item in every row."""
        return query_cm_counters(self.counters, items, self.cfg, plan)

    def topk(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row heavy hitters from the Topkapi label slots.

        Candidates are the d*w surviving labels of each row, deduplicated
        and ranked by their count-min estimate (descending; ties to the
        larger value), all on the bank's device.  Returns ``(values,
        counts)`` as (B, k) int32 / uint64 host arrays; rows with fewer than
        k distinct labels pad with value -1 / count 0.
        """
        if k < 1:
            raise ValueError(f"topk needs k >= 1, got {k}")
        rows = len(self)
        values = np.full((rows, k), -1, np.int32)
        counts = np.zeros((rows, k), np.uint64)
        if rows == 0:
            return values, counts
        cand = self.labels.reshape(rows, -1)
        ests = _query_rowwise(self.counters, cand, self.cfg)
        top_v, top_e, distinct = _rank_topk(cand, ests, k)
        top_v = torch.where(distinct, top_v, -1).cpu().numpy()
        top_e = torch.where(distinct, top_e, 0).cpu().numpy()
        values[:, : top_v.shape[1]] = top_v
        counts[:, : top_e.shape[1]] = top_e.astype(np.uint64)
        return values, counts

    # ------------------------------------------------------------------
    # serialization (RCMB: strict sibling of RHLB)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """24-byte header + B uint64 counts + counter/label/vote tables."""
        header = _CM_HEADER.pack(
            _CM_MAGIC, _CM_VERSION, self.cfg.depth, 0, self.cfg.seed, self.cfg.width, len(self),
        )
        counts = self.counts.astype("<u8").tobytes()
        tables = [t.detach().cpu().numpy() for t in (self.counters, self.labels, self.label_counts)]
        return (
            header
            + counts
            + tables[0].view(np.uint32).astype("<u4").tobytes()
            + tables[1].astype("<i4").tobytes()
            + tables[2].astype("<i4").tobytes()
        )

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "CountMinBank":
        if len(data) < _CM_HEADER.size:
            raise ValueError(f"truncated count-min bank: {len(data)} bytes")
        magic, version, depth, _flags, seed, width, rows = _CM_HEADER.unpack(
            data[: _CM_HEADER.size]
        )
        if magic != _CM_MAGIC:
            raise ValueError(f"bad magic {magic!r}; not a serialized count-min bank")
        if version != _CM_VERSION:
            raise ValueError(f"unsupported count-min bank version {version}")
        if rows < 1:
            raise ValueError(f"count-min header claims {rows} rows")
        cfg = CMConfig(depth=depth, width=width, seed=seed)
        cells = rows * cfg.cells
        counts_end = _CM_HEADER.size + rows * _ROW_COUNT.size
        expected = counts_end + 3 * 4 * cells
        if len(data) != expected:
            # covers payloads cut anywhere: mid-counts, mid-counter, and
            # mid-label-table alike
            raise ValueError(
                f"count-min payload is {len(data)} bytes, expected "
                f"{expected} for {rows} rows of d={depth}, w={width}"
            )
        device = hll.resolve_device(device)
        raw_counts = np.frombuffer(data[_CM_HEADER.size : counts_end], "<u8")
        shape = (rows, cfg.depth, cfg.width)
        cnt_end = counts_end + 4 * cells
        lab_end = cnt_end + 4 * cells
        tables = (
            np.frombuffer(data[counts_end:cnt_end], "<u4").astype(np.uint32).view(np.int32),
            np.frombuffer(data[cnt_end:lab_end], "<i4").astype(np.int32),
            np.frombuffer(data[lab_end:], "<i4").astype(np.int32),
        )
        counters, labels, votes = (torch.from_numpy(t.reshape(shape)).to(device) for t in tables)
        return cls(counters, labels, votes, u64.from_numpy(raw_counts, device), cfg)


# ----------------------------------------------------------------------------
# the windowed ring (DESIGN.md §11 contract, sum-fold flavor)
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WindowedCountMinBank(_RingReads):
    """A (W, B, d, w) ring of time-bucket count-min banks as one value.

    The ring/rotation contract is ``WindowedBank``'s (host epoch labels and
    cursor, expiry-on-overwrite, monotone ``advance_to``); the window fold
    differs in lattice only -- counters SUM over the live buckets and label
    tables merge pairwise with the Topkapi rule in slot order.  Carriers are
    functional: ``observe`` and ``advance_to`` return new instances and copy
    the ring.
    """

    counters: torch.Tensor  # (W, B, d, w) int32 holding uint32 bits
    labels: torch.Tensor  # (W, B, d, w) int32
    label_counts: torch.Tensor  # (W, B, d, w) int32
    n_items: torch.Tensor  # (W, B, 2) int64 (hi, lo) limb pairs per bucket row
    cursor: int  # ring slot of the newest epoch
    epochs: np.ndarray  # (W,) int32 absolute epoch held by each slot
    cfg: CMConfig

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def empty(
        cls, window: int, rows: int, cfg: Optional[CMConfig] = None, device=None
    ) -> "WindowedCountMinBank":
        cfg = cfg or CMConfig()
        if window < 1:
            raise ValueError(f"a window needs at least one bucket, got {window}")
        if rows < 1:
            raise ValueError(f"a bank needs at least one row, got {rows}")
        device = hll.resolve_device(device)
        shape = (window, rows, cfg.depth, cfg.width)
        return cls(
            torch.zeros(shape, dtype=COUNTER_DTYPE, device=device),
            torch.zeros(shape, dtype=LABEL_DTYPE, device=device),
            torch.zeros(shape, dtype=LABEL_DTYPE, device=device),
            torch.zeros((window, rows, 2), dtype=torch.int64, device=device),
            0,
            _ring_epochs(0, window),
            cfg,
        )

    def with_rows(self, rows: int) -> "WindowedCountMinBank":
        """Grow the bank axis to ``rows`` (new rows start empty)."""
        have = self.rows
        if rows < have:
            raise ValueError(f"cannot shrink a {have}-row window to {rows}")
        if rows == have:
            return self
        grow = (0, 0, 0, 0, 0, rows - have)
        pad = torch.nn.functional.pad
        return dataclasses.replace(
            self,
            counters=pad(self.counters, grow),
            labels=pad(self.labels, grow),
            label_counts=pad(self.label_counts, grow),
            n_items=pad(self.n_items, (0, 0, 0, rows - have)),
        )

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def window(self) -> int:
        return int(self.counters.shape[0])

    @property
    def rows(self) -> int:
        return int(self.counters.shape[1])

    def __len__(self) -> int:
        return self.rows

    @property
    def device(self) -> torch.device:
        return self.counters.device

    @property
    def counts(self) -> np.ndarray:
        """(W, B) exact per-bucket-per-row observation counts as uint64."""
        return u64.to_numpy(self.n_items)

    @functools.cached_property
    def _epochs_on_device(self) -> torch.Tensor:
        return _to_device(np.asarray(self.epochs, dtype=np.int32), self.device)

    def _live_mask(self, last_k: int) -> torch.Tensor:
        """(W,) bool on the ring's device: the ``last_k`` newest epochs."""
        return self._epochs_on_device > self.epoch - last_k

    # ------------------------------------------------------------------
    # ingestion (current bucket)
    # ------------------------------------------------------------------

    def observe(self, keys, items, plan: Optional[ExecutionPlan] = None) -> "WindowedCountMinBank":
        """Route each item to row ``keys[i]`` of the CURRENT time bucket.

        The current bucket IS a ``CountMinBank``, so ingest delegates to
        ``CountMinBank.update_many`` wholesale -- the §9 validation, drop,
        counter, and short-circuit rules cannot drift from the flat path.
        """
        slot = self.cursor
        cur = CountMinBank(
            self.counters[slot], self.labels[slot], self.label_counts[slot], self.n_items[slot], self.cfg
        )
        new = cur.update_many(keys, items, plan)
        if new is cur:  # the empty-stream short-circuit: nothing to write back
            return self
        rings = {}
        for field in ("counters", "labels", "label_counts", "n_items"):
            ring = getattr(self, field).clone()
            ring[self.cursor] = getattr(new, field)
            rings[field] = ring
        return dataclasses.replace(self, **rings)

    # ------------------------------------------------------------------
    # rotation
    # ------------------------------------------------------------------

    def advance(self, steps: int = 1) -> "WindowedCountMinBank":
        """Open ``steps`` new epochs, expiring the buckets they overwrite."""
        if steps < 1:
            raise ValueError(f"advance needs steps >= 1, got {steps}")
        return self.advance_to(self.epoch + steps)

    def advance_to(self, epoch: int) -> "WindowedCountMinBank":
        """Rotate forward so ``epoch`` is current; the past never returns.

        Same rules as ``WindowedBank.advance_to``: overwritten slots
        zero-fill (counters, labels AND votes), jumps >= W expire the whole
        ring, and a target at or before the current epoch is a no-op.
        """
        current = self.epoch
        target = max(int(epoch), current)
        window = self.window
        steps = target - current
        fields = ("counters", "labels", "label_counts", "n_items")
        if steps == 0:
            rings = {}  # never written in place
        elif steps >= window:
            rings = {f: torch.zeros_like(getattr(self, f)) for f in fields}
        else:
            rings = {f: getattr(self, f).clone() for f in fields}
            start = (self.cursor + 1) % window
            for lo, hi in ((start, min(start + steps, window)), (0, max(0, start + steps - window))):
                for ring in rings.values():
                    ring[lo:hi] = 0
        return dataclasses.replace(
            self, cursor=target % window, epochs=_ring_epochs(target, window), **rings
        )

    # ------------------------------------------------------------------
    # windowed queries
    # ------------------------------------------------------------------

    def fold_window(
        self, last_k: Optional[int] = None, plan: Optional[ExecutionPlan] = None
    ) -> CountMinBank:
        """The ``last_k``-epoch suffix collapsed to a flat ``CountMinBank``.

        Counters fold with ONE masked SUM-reduce over the ring axis (the cm
        window backend registered under ``plan.backend``); label tables
        merge pairwise in slot order with the Topkapi rule (not associative
        in general, so the order is the reference's); the exact per-row
        counters sum the live buckets host-side.  A zero-row ring folds to
        a zero-row bank without dispatching any backend.
        """
        last_k = self._check_last_k(last_k)
        plan = (DEFAULT_PLAN if plan is None else plan).validate()
        if self.rows == 0:
            return CountMinBank(
                self.counters[0], self.labels[0], self.label_counts[0], self.n_items[0], self.cfg
            )
        backend = get_cm_window_backend(plan.backend)
        counters = backend(self.counters, self._live_mask(last_k), self.cfg, plan)
        live = np.flatnonzero(self._host_live_mask(last_k))  # never empty: cursor is live
        labels, votes = self.labels[live[0]], self.label_counts[live[0]]
        for s in live[1:]:
            labels, votes = _merge_label_tables(labels, votes, self.labels[s], self.label_counts[s])
        totals = u64.from_numpy(self.window_counts(last_k), self.device)
        return CountMinBank(counters, labels, votes, totals, self.cfg)

    def query_window(
        self, items, last_k: Optional[int] = None, plan: Optional[ExecutionPlan] = None
    ) -> torch.Tensor:
        """(B, n) int64 estimated counts over the ``last_k`` newest epochs."""
        return self.fold_window(last_k, plan).query(items, plan)

    def topk_window(
        self, k: int, last_k: Optional[int] = None, plan: Optional[ExecutionPlan] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row heavy hitters over the ``last_k`` newest epochs."""
        return self.fold_window(last_k, plan).topk(k)

    # ------------------------------------------------------------------
    # serialization (RCMW: window header + epochs + RCMB payloads)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """32-byte window header + W int32 epochs + W RCMB bucket blobs."""
        header = _CMW_HEADER.pack(
            _CMW_MAGIC, _CMW_VERSION, self.cfg.depth, 0, self.cfg.seed, self.cfg.width,
            self.window, self.rows, self.cursor,
        )
        epochs = np.asarray(self.epochs, dtype=_EPOCH).tobytes()
        host = [getattr(self, f).cpu() for f in ("counters", "labels", "label_counts", "n_items")]
        buckets = b"".join(
            CountMinBank(*(t[w] for t in host), self.cfg).to_bytes() for w in range(self.window)
        )
        return header + epochs + buckets

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "WindowedCountMinBank":
        if len(data) < _CMW_HEADER.size:
            raise ValueError(f"truncated count-min window: {len(data)} bytes")
        magic, version, depth, _flags, seed, width, window, rows, cursor = (
            _CMW_HEADER.unpack(data[: _CMW_HEADER.size])
        )
        if magic != _CMW_MAGIC:
            raise ValueError(f"bad magic {magic!r}; not a serialized count-min window")
        if version != _CMW_VERSION:
            raise ValueError(f"unsupported count-min window version {version}")
        if window < 1 or rows < 1:
            raise ValueError(f"window header claims {window} buckets x {rows} rows")
        if cursor >= window:
            raise ValueError(f"cursor {cursor} out of range for W={window}")
        cfg = CMConfig(depth=depth, width=width, seed=seed)
        epochs_end = _CMW_HEADER.size + window * _EPOCH.itemsize
        bucket_size = _CM_HEADER.size + rows * _ROW_COUNT.size + 12 * rows * cfg.cells
        expected = epochs_end + window * bucket_size
        if len(data) != expected:
            # covers payloads cut mid-bucket and mid-label-table alike
            raise ValueError(
                f"count-min window payload is {len(data)} bytes, expected "
                f"{expected} for W={window}, B={rows}, d={depth}, w={width}"
            )
        epochs = np.frombuffer(data[_CMW_HEADER.size : epochs_end], _EPOCH).astype(np.int64)
        _validate_epoch_ring(epochs, cursor, window)
        buckets = []
        for w in range(window):
            start = epochs_end + w * bucket_size
            bucket = CountMinBank.from_bytes(data[start : start + bucket_size], device="cpu")
            if bucket.cfg != cfg or len(bucket) != rows:
                raise ValueError(f"bucket {w} disagrees with the window header")
            buckets.append(bucket)
        device = hll.resolve_device(device)
        stack = lambda f: torch.stack([getattr(b, f) for b in buckets]).to(device)
        return cls(
            stack("counters"), stack("labels"), stack("label_counts"), stack("n_items"),
            int(cursor), epochs.astype(_EPOCH), cfg,
        )


# ----------------------------------------------------------------------------
# the batched entry point, roadmap-style
# ----------------------------------------------------------------------------


def cm_update_many(
    bank: CountMinBank, keys, items, plan: Optional[ExecutionPlan] = None
) -> CountMinBank:
    """Batched heavy-hitter ingestion: one fused dispatch for the bank."""
    return bank.update_many(keys, items, plan)
