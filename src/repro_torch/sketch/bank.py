"""SketchBank: a stacked (B, m) register bank with keyed batched ingestion.

Port of ``repro/sketch/bank.py``.  A ``SketchBank``
carries B sketches that share one static ``HLLConfig`` -- (B, m) uint8
registers plus a (B, 2) int64 tensor of (hi, lo) uint32 limbs counting each
row's observations exactly -- and ``update_many(bank, keys, items, plan)``
routes every item to its owning row by key and applies the whole batch in
one fused scatter-max.

Key-routing contract (DESIGN.md §9):

* ``keys`` and ``items`` flatten to the same length; item i belongs to the
  sketch at row ``keys[i]``.
* valid keys are ``0 <= key < len(bank)``; out-of-range keys are DROPPED,
  never clamped into a neighboring row, and do not count.
* every registered bank backend is bit-identical to the per-sketch loop
  ``for b: bank[b].update(items[keys == b])``.

Serialization is the RHLB v1 format, byte-identical to the reference's;
``to_hybrid`` demotes a bank to the sparse/dense ``HybridBank`` layout
(DESIGN.md §12), whose RHLB v2 format ``from_bytes`` here still rejects.
Entry points run on the card unless the caller asks for the CPU:
``empty`` and ``from_bytes`` default to ``torch.device("cuda")``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.bank_count import bank_row_count
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing
from repro_torch.sketch import hll, u64
from repro_torch.sketch.carrier import HyperLogLog
from repro_torch.sketch.dispatch import mesh_fold, row_shard_apply, row_shard_fold
from repro_torch.sketch.hll import HLLConfig
from repro_torch.sketch.plan import DEFAULT_PLAN, ExecutionPlan, get_bank_backend

_BANK_HEADER = struct.Struct("<4sBBBBQI")  # magic, ver, p, H, flags, seed, B
_BANK_MAGIC = b"RHLB"
_BANK_VERSION = 1
_ROW_COUNT = struct.Struct("<Q")


def _flat_keys_items(keys, items, device):
    """Keys as flat int32 and items as flat int32 bits, on ``device``."""
    if isinstance(keys, torch.Tensor):
        flat_keys = keys.reshape(-1).to(device=device, dtype=torch.int32)
    else:
        flat_keys = torch.from_numpy(
            np.ascontiguousarray(np.asarray(keys).reshape(-1).astype(np.int32))
        ).to(device)
    flat_items = hll.as_items(items, device)
    if flat_keys.shape[0] != flat_items.shape[0]:
        raise ValueError(
            f"keys ({flat_keys.shape[0]}) and items ({flat_items.shape[0]}) "
            f"must flatten to the same length"
        )
    return flat_keys, flat_items


# ----------------------------------------------------------------------------
# functional dispatch (mirrors sketch.dispatch.update_registers)
# ----------------------------------------------------------------------------


def update_bank_registers(
    registers: torch.Tensor,
    keys,
    items,
    cfg: HLLConfig,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """Keyed scatter-max of ``items`` into a raw (B, m) register bank.

    The bank-capable backend registered under ``plan.backend`` runs the
    fused update on the bank's device; placement="mesh" shards the (keys,
    items) pair through the same :func:`repro_torch.sketch.dispatch.mesh_fold`
    rule as the single-sketch path (per-shard partial banks + one max fold,
    edge-padding for non-divisible streams); placement="sharded" splits
    the BANK'S ROW AXIS over the mesh instead and routes keys by re-basing
    them into each shard's block (DESIGN.md §16) -- the §9 drop rule
    discards foreign keys, so no fold is needed and bit-identity to local
    holds row by row.
    """
    plan = (DEFAULT_PLAN if plan is None else plan).validate()
    backend = get_bank_backend(plan.backend)
    flat_keys, flat_items = _flat_keys_items(keys, items, registers.device)
    if flat_items.shape[0] == 0 or registers.shape[0] == 0:
        # nothing to land (or nowhere to land it): no backend dispatch
        return registers
    if plan.placement == "local":
        return backend(registers, flat_keys, flat_items, cfg, plan)

    def apply(regs, ks, xs):
        return backend(regs, ks, xs, cfg, plan)

    if plan.placement == "sharded":
        return row_shard_fold(plan, registers, flat_keys, (flat_items,), apply)
    return mesh_fold(plan, registers, (flat_keys, flat_items), apply)


def estimate_rows(registers: torch.Tensor, cfg: HLLConfig, estimator: Optional[str],
                  plan: Optional[ExecutionPlan]) -> torch.Tensor:
    """(B,) estimates of a (B, m) register bank under ``plan``'s placement:
    per row block for placement="sharded" (§16), else one batched pass (§8)."""
    from repro_torch.sketch import estimators as _estimators

    def apply(regs):
        return _estimators.estimate_many(regs, cfg, estimator=estimator)

    if plan is not None and plan.placement == "sharded":
        return row_shard_apply(plan, apply, (registers,), (0,))
    return apply(registers)


# ----------------------------------------------------------------------------
# the carrier
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SketchBank:
    """B same-config sketches as one value: the multi-tenant carrier."""

    registers: torch.Tensor  # (B, m) uint8
    n_items: torch.Tensor  # (B, 2) int64 (hi, lo) limbs, exact per-row counts
    cfg: HLLConfig

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def empty(cls, rows: int, cfg: Optional[HLLConfig] = None, device=None) -> "SketchBank":
        cfg = cfg or HLLConfig()
        if rows < 1:
            raise ValueError(f"a bank needs at least one row, got {rows}")
        device = hll.resolve_device(device)
        return cls(
            torch.zeros((rows, cfg.m), dtype=hll.REGISTER_DTYPE, device=device),
            torch.zeros((rows, 2), dtype=torch.int64, device=device),
            cfg,
        )

    @classmethod
    def from_sketches(cls, sketches: Sequence[HyperLogLog]) -> "SketchBank":
        """Stack same-config carriers into one bank (counters preserved)."""
        if not sketches:
            raise ValueError("from_sketches needs at least one sketch")
        cfg = sketches[0].cfg
        for sk in sketches[1:]:
            if sk.cfg != cfg:
                raise ValueError(f"bank rows must share one config: {sk.cfg} vs {cfg}")
        return cls(
            torch.stack([sk.registers for sk in sketches]),
            torch.stack([sk.n_items for sk in sketches]),
            cfg,
        )

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return int(self.registers.shape[0])

    @property
    def device(self) -> torch.device:
        return self.registers.device

    def row(self, i: int) -> HyperLogLog:
        """Row ``i`` as a standalone carrier (registers + exact counter)."""
        rows = len(self)
        if not -rows <= i < rows:
            raise IndexError(f"row {i} out of range for a {rows}-row bank")
        return HyperLogLog(self.registers[i], self.n_items[i], self.cfg)

    def to_sketches(self) -> list:
        return [self.row(i) for i in range(len(self))]

    @property
    def counts(self) -> np.ndarray:
        """(B,) exact per-row observation counts as uint64."""
        return u64.to_numpy(self.n_items)

    @property
    def nbytes(self) -> int:
        """Storage footprint of the dense representation, in the reference's
        layout (uint8 registers + uint32 counter limbs, 8 B per row), so the
        two packages report the same sizes."""
        return int(self.registers.numel() + 8 * len(self))

    def density(self) -> dict:
        """Storage introspection, schema-compatible with the hybrid bank's.

        A dense bank is all-dense by construction; ``occupancy_mean``
        reports how full the registers actually are, which is what decides
        whether ``to_hybrid()`` would pay off (DESIGN.md §12).
        """
        rows = len(self)
        occ = (self.registers > 0).sum(dim=1, dtype=torch.int64).cpu().numpy()
        return {
            "rows": rows,
            "dense_rows": rows,
            "sparse_rows": 0,
            "capacity": 0,
            "threshold": None,
            "occupancy_mean": float(occ.mean() / self.cfg.m) if rows else 0.0,
            "nbytes": self.nbytes,
            "dense_nbytes": self.nbytes,
            "reduction": 1.0,
        }

    def to_hybrid(self, threshold: Optional[int] = None, dense_rows=None):
        """Demote to the sparse/dense ``HybridBank`` layout (DESIGN.md §12)."""
        from repro_torch.sketch.sparse import HybridBank

        return HybridBank.from_dense(self, threshold, dense_rows=dense_rows)

    # ------------------------------------------------------------------
    # aggregation (paper phase 3, bank-wide)
    # ------------------------------------------------------------------

    def update_many(
        self,
        keys,
        items,
        plan: Optional[ExecutionPlan] = None,
    ) -> "SketchBank":
        """Route each item to row ``keys[i]`` and apply one fused update.

        A zero-length stream returns ``self`` without dispatching any
        backend (and without touching the counters).
        """
        flat_keys, flat_items = _flat_keys_items(keys, items, self.device)
        if flat_items.shape[0] == 0 or len(self) == 0:
            return self
        with tracing.region("sketch.bank.update_many"):
            obs_metrics.observe("bank.update_many.batch_items", flat_items.shape[0])
            regs = update_bank_registers(self.registers, flat_keys, flat_items, self.cfg, plan)
            # count only the observations that actually landed (dropped keys
            # must not inflate a row's exact counter)
            with tracing.region("sketch.bank.counters"):
                n_items = bank_row_count(self.n_items, flat_keys)
            return dataclasses.replace(self, registers=regs, n_items=n_items)

    def merge(self, other: "SketchBank") -> "SketchBank":
        """Row-wise Merge-buckets fold; counters add exactly."""
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
        return dataclasses.replace(
            self,
            registers=torch.maximum(self.registers, other.registers),
            n_items=u64.add(self.n_items, other.n_items),
        )

    __or__ = merge

    # ------------------------------------------------------------------
    # estimation (paper phase 4, batched)
    # ------------------------------------------------------------------

    def estimate_many(
        self,
        estimator: Optional[str] = None,
        plan: Optional[ExecutionPlan] = None,
    ) -> torch.Tensor:
        """(B,) float32 estimates in one batched pass on the bank's device.

        Under a placement="sharded" ``plan`` each shard finalizes its own
        row block (DESIGN.md §16) -- the histogram is per-row, so the
        blocked read is the flat one row for row.
        """
        if len(self) == 0:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        with tracing.region("sketch.bank.estimate_many"):
            name = estimator
            if plan is not None:
                name = estimator or plan.validate().estimator
            return estimate_rows(self.registers, self.cfg, name, plan)

    def estimate(self, i: int, estimator: Optional[str] = None) -> float:
        """Exact host-side estimate of one row."""
        return self.row(i).estimate(estimator)

    # ------------------------------------------------------------------
    # serialization (DESIGN.md §7, bank framing)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """20-byte bank header + B uint64 counts + B*m register bytes."""
        header = _BANK_HEADER.pack(
            _BANK_MAGIC,
            _BANK_VERSION,
            self.cfg.p,
            self.cfg.hash_bits,
            0,
            self.cfg.seed,
            len(self),
        )
        counts = self.counts.astype("<u8").tobytes()
        regs = self.registers.detach().cpu().numpy().astype(np.uint8)
        return header + counts + regs.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "SketchBank":
        if len(data) < _BANK_HEADER.size:
            raise ValueError(f"truncated bank: {len(data)} bytes")
        magic, version, p, hash_bits, _flags, seed, rows = _BANK_HEADER.unpack(
            data[: _BANK_HEADER.size]
        )
        if magic != _BANK_MAGIC:
            raise ValueError(f"bad magic {magic!r}; not a serialized bank")
        if version != _BANK_VERSION:
            hint = (
                "; version 2 is the hybrid sparse format — parse it with "
                "repro_torch.sketch.sparse.HybridBank.from_bytes"
                if version == 2
                else ""
            )
            raise ValueError(f"unsupported bank version {version}{hint}")
        if rows < 1:
            raise ValueError(f"bank header claims {rows} rows")
        cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
        counts_end = _BANK_HEADER.size + rows * _ROW_COUNT.size
        expected = counts_end + rows * cfg.m
        if len(data) != expected:
            raise ValueError(
                f"bank payload is {len(data)} bytes, expected {expected} "
                f"for {rows} rows of m={cfg.m}"
            )
        device = hll.resolve_device(device)
        raw_counts = np.frombuffer(data[_BANK_HEADER.size : counts_end], dtype="<u8")
        regs = np.frombuffer(data[counts_end:], dtype=np.uint8).reshape(rows, cfg.m)
        return cls(
            torch.from_numpy(regs.copy()).to(device),
            u64.from_numpy(raw_counts, device),
            cfg,
        )


# ----------------------------------------------------------------------------
# the batched entry point named by the roadmap
# ----------------------------------------------------------------------------


def update_many(
    bank: SketchBank,
    keys,
    items,
    plan: Optional[ExecutionPlan] = None,
) -> SketchBank:
    """Batched multi-tenant ingestion: one fused dispatch for the bank."""
    return bank.update_many(keys, items, plan)
