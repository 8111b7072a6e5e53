"""HyperLogLog: the sketch carrier -- the public object API.

Port of ``repro/sketch/carrier.py``.  A frozen dataclass holding the (m,)
uint8 register tensor, an exact 64-bit item counter and the static
HLLConfig.  All methods are functional (return new carriers);
``merge``/``|`` is the paper's Merge-buckets fold and obeys the max-lattice
laws (associative, commutative, idempotent -- DESIGN.md §6).

The item counter is a (2,) int64 tensor of (hi, lo) uint32 limbs, on the
registers' device: it counts exactly to 2^64 (past int64) and maps one to
one onto the reference's (2,) uint32 counter.

``to_bytes``/``from_bytes`` is the dense RHLL v1 wire format (DESIGN.md
§7): a 24-byte header + the raw registers, byte-identical to the
reference's, so either package parses the other's blobs.

Entry points run on the card unless the caller asks for the CPU:
``empty(cfg)`` and ``from_bytes(data)`` default to ``torch.device("cuda")``;
``of(items)`` takes its device from a tensor argument and defaults to the
card for anything else.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import tracing
from repro_torch.sketch import hll, setops, u64
from repro_torch.sketch.dispatch import update_registers
from repro_torch.sketch.hll import HLLConfig
from repro_torch.sketch.plan import ExecutionPlan

_HEADER = struct.Struct("<4sBBBBQQ")  # magic, ver, p, H, flags, seed, n_items
_MAGIC = b"RHLL"
_VERSION = 1


@dataclasses.dataclass(frozen=True)
class HyperLogLog:
    """Registers + exact item counter + static config, as one value."""

    registers: torch.Tensor  # (m,) uint8
    n_items: torch.Tensor  # (2,) int64: (hi, lo) uint32 limbs of the count
    cfg: HLLConfig

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def empty(cls, cfg: Optional[HLLConfig] = None, device=None) -> "HyperLogLog":
        cfg = cfg or HLLConfig()
        regs = hll.init_registers(cfg, device)
        return cls(regs, torch.zeros((2,), dtype=torch.int64, device=regs.device), cfg)

    @classmethod
    def of(
        cls,
        items,
        cfg: Optional[HLLConfig] = None,
        plan: Optional[ExecutionPlan] = None,
        device=None,
    ) -> "HyperLogLog":
        """One-shot: sketch a whole array (on a tensor's own device)."""
        if device is None and isinstance(items, torch.Tensor):
            device = items.device
        return cls.empty(cfg, device).update(items, plan)

    @property
    def device(self) -> torch.device:
        return self.registers.device

    # ------------------------------------------------------------------
    # aggregation (paper phase 3)
    # ------------------------------------------------------------------

    def update(self, items, plan: Optional[ExecutionPlan] = None) -> "HyperLogLog":
        """Aggregate a batch under ``plan`` (any backend/pipelines).

        A zero-length batch returns ``self`` without dispatching any
        backend (the update is the lattice identity).
        """
        flat = hll.as_items(items, self.device)
        if flat.numel() == 0:
            return self
        with tracing.region("sketch.update"):
            regs = update_registers(self.registers, flat, self.cfg, plan)
            return dataclasses.replace(
                self,
                registers=regs,
                n_items=u64.add(self.n_items, flat.numel()),
            )

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        """Merge-buckets fold: element-wise max; counters add exactly."""
        if self.cfg != other.cfg:
            raise ValueError(
                f"cannot merge sketches with different configs: "
                f"{self.cfg} vs {other.cfg}"
            )
        return dataclasses.replace(
            self,
            registers=torch.maximum(self.registers, other.registers),
            n_items=u64.add(self.n_items, other.n_items),
        )

    __or__ = merge

    # ------------------------------------------------------------------
    # estimation (paper phase 4) + set algebra
    # ------------------------------------------------------------------

    def estimate(self, estimator: Optional[str] = None) -> float:
        """Exact host-side cardinality estimate (registry-dispatched)."""
        return hll.estimate(self.registers, self.cfg, estimator=estimator)

    def estimate_device(self, estimator: Optional[str] = None) -> torch.Tensor:
        """Float32 estimate on the sketch's device, for in-step telemetry."""
        return hll.estimate_device(self.registers, self.cfg, estimator=estimator)

    def histogram(self) -> torch.Tensor:
        """Register-value histogram C[k] -- the phase-4 intermediate."""
        from repro_torch.sketch.estimators import register_histogram

        return register_histogram(self.registers, self.cfg)

    def union_estimate(self, other: "HyperLogLog", estimator: Optional[str] = None) -> float:
        self._check_peer(other)
        return setops.union_estimate(
            self.registers, other.registers, self.cfg, estimator=estimator
        )

    def intersection_estimate(
        self, other: "HyperLogLog", estimator: Optional[str] = None
    ) -> Tuple[float, float]:
        """(|A ∩ B| estimate, absolute-error bound) via inclusion-exclusion."""
        self._check_peer(other)
        return setops.intersection_estimate(
            self.registers, other.registers, self.cfg, estimator=estimator
        )

    def difference_estimate(
        self, other: "HyperLogLog", estimator: Optional[str] = None
    ) -> float:
        self._check_peer(other)
        return setops.difference_estimate(
            self.registers, other.registers, self.cfg, estimator=estimator
        )

    def jaccard(self, other: "HyperLogLog", estimator: Optional[str] = None) -> float:
        self._check_peer(other)
        return setops.jaccard_estimate(
            self.registers, other.registers, self.cfg, estimator=estimator
        )

    def _check_peer(self, other: "HyperLogLog") -> None:
        if self.cfg != other.cfg:
            raise ValueError(
                f"set operations need matching configs: {self.cfg} vs {other.cfg}"
            )

    # ------------------------------------------------------------------
    # counters / introspection
    # ------------------------------------------------------------------

    @property
    def count(self) -> int:
        """Exact number of items observed (python int, up to 2^64)."""
        return u64.to_py(self.n_items)

    @property
    def standard_error(self) -> float:
        return hll.standard_error(self.cfg)

    def duplication(self) -> float:
        """items seen / distinct estimate (stream redundancy factor)."""
        est = self.estimate()
        return (self.count / est) if est > 0 else float("nan")

    # ------------------------------------------------------------------
    # serialization (DESIGN.md §7)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Dense wire format: 24-byte header + m raw register bytes."""
        header = _HEADER.pack(
            _MAGIC, _VERSION, self.cfg.p, self.cfg.hash_bits, 0,
            self.cfg.seed, self.count,
        )
        return header + self.registers.detach().cpu().numpy().astype(np.uint8).tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "HyperLogLog":
        if len(data) < _HEADER.size:
            raise ValueError(f"truncated sketch: {len(data)} bytes")
        magic, version, p, hash_bits, _flags, seed, n_items = _HEADER.unpack(
            data[: _HEADER.size]
        )
        if magic != _MAGIC:
            raise ValueError(f"bad magic {magic!r}; not a serialized sketch")
        if version != _VERSION:
            raise ValueError(f"unsupported sketch version {version}")
        cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
        body = data[_HEADER.size :]
        if len(body) != cfg.m:
            raise ValueError(
                f"register payload is {len(body)} bytes, expected {cfg.m}"
            )
        device = hll.resolve_device(device)
        regs = torch.from_numpy(np.frombuffer(body, dtype=np.uint8).copy()).to(device)
        return cls(regs, u64.from_py(n_items, device), cfg)
