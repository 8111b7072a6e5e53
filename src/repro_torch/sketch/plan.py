"""ExecutionPlan: config-driven dispatch for the sketch aggregation phase.

Port of ``repro/sketch/plan.py``, with the two registry axes the main path
needs (single-sketch ingest and bank ingest); the other five axes arrive
with their slices.  The backends:

  backend    "torch"            eager PyTorch scatter-max, on the CPU or
                                the card (the reference's "jnp")
             "cuda"             the fused CUDA kernel: hash, rank and
                                register max in one launch, registers in
                                shared memory (the reference's "pallas")
             "cuda_pipelined"   k fused CUDA launches + the bucket-fold
                                kernel (paper Fig. 3 built from kernels;
                                the reference's "pallas_pipelined")
  placement  "local"            one device; "mesh" and "sharded" raise
                                NotImplementedError until the placement
                                slice (ROADMAP A.10) ports them
  pipelines  k sub-sketch lanes per device (paper Fig. 3); every backend
             produces registers bit-identical to the k=1 reference because
             max is associative/commutative/idempotent (DESIGN.md §6).
  estimator  phase-4 finalizer name, resolved against
             repro_torch/sketch/estimators.py.

``DEFAULT_PLAN.backend`` is "cuda", where the reference's default is
"jnp": the port exists to run the paper's datapath through its
hand-written kernels on the card, so the normal entry points go through
them.  On a CPU tensor every kernel wrapper runs its plain PyTorch version,
so the default plan still works there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.sketch.estimators import DEFAULT_ESTIMATOR, get_estimator

DEFAULT_PIPELINES = 8

PLACEMENTS = ("local", "mesh", "sharded")

# backend name -> fn(registers, flat_items, cfg, plan) -> registers
_BACKENDS: Dict[str, Callable] = {}

# backend name -> fn(bank_registers, keys, flat_items, cfg, plan) -> bank.
# Bank ingest paths register under the SAME names as their single-sketch
# counterparts, so one ExecutionPlan drives both `update_registers` and
# `update_many` (DESIGN.md §9).
_BANK_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register an aggregation backend under ``name``."""

    def deco(fn: Callable) -> Callable:
        if name in _BACKENDS:
            raise ValueError(f"backend {name!r} already registered")
        # the reference wraps fn in repro.obs's per-backend dispatch
        # counter here; the obs slice (ROADMAP A.9) threads that in
        _BACKENDS[name] = fn
        return fn

    return deco


def register_bank_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a batched (SketchBank) ingest path under ``name``.

    The signature is fn(bank_registers, keys, flat_items, cfg, plan) ->
    (B, m) registers.  A backend without a bank entry still works for
    single-sketch plans; `update_many` raises a targeted error for it.
    """

    def deco(fn: Callable) -> Callable:
        if name in _BANK_BACKENDS:
            raise ValueError(f"bank backend {name!r} already registered")
        # obs wrap_backend site left out until the obs slice (ROADMAP A.9)
        _BANK_BACKENDS[name] = fn
        return fn

    return deco


def get_backend(name: str) -> Callable:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {sorted(_BACKENDS)}"
        ) from None


def get_bank_backend(name: str) -> Callable:
    try:
        return _BANK_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"backend {name!r} has no bank ingest path; bank-capable: "
            f"{sorted(_BANK_BACKENDS)}"
        ) from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def available_bank_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BANK_BACKENDS))


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Where and how one ``update()`` call runs.  Hashable."""

    backend: str = "cuda"
    placement: str = "local"
    pipelines: int = DEFAULT_PIPELINES
    mesh: Optional[Any] = None
    data_axes: Tuple[str, ...] = ("data",)
    # Pallas interpret mode in the reference.  A CUDA kernel has no
    # interpret mode (a CPU tensor runs the plain version instead), so
    # only None and False are accepted.
    interpret: Optional[bool] = None
    # phase-4 finalizer ("original" | "ertl_improved" | "ertl_mle" | plugins)
    estimator: str = DEFAULT_ESTIMATOR
    # storage hint for the hybrid carriers of a later slice (ROADMAP A.6)
    sparse_threshold: Optional[int] = None

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"placement must be one of {PLACEMENTS}, got {self.placement!r}"
            )
        if self.placement != "local":
            raise NotImplementedError(
                f"placement={self.placement!r} is not ported yet: the port "
                f"runs placement='local' only until the placement slice "
                f"(ROADMAP A.10) brings mesh and row-sharded banks"
            )
        if self.pipelines < 1:
            raise ValueError(f"pipelines must be >= 1, got {self.pipelines}")
        if self.interpret:
            raise ValueError(
                "CUDA kernels have no interpret mode; put the tensors on the "
                "CPU to run the plain PyTorch versions"
            )
        if self.sparse_threshold is not None and self.sparse_threshold < 1:
            raise ValueError(
                f"sparse_threshold must be >= 1, got {self.sparse_threshold}"
            )
        object.__setattr__(self, "data_axes", tuple(self.data_axes))

    def validate(self) -> "ExecutionPlan":
        """Check backend + estimator exist (deferred so plans build early)."""
        get_backend(self.backend)
        get_estimator(self.estimator)
        return self

    def with_mesh(self, mesh, data_axes=("data",)) -> "ExecutionPlan":
        return dataclasses.replace(
            self, placement="mesh", mesh=mesh, data_axes=tuple(data_axes)
        )

    def with_sharding(self, mesh, data_axes=("data",)) -> "ExecutionPlan":
        return dataclasses.replace(
            self, placement="sharded", mesh=mesh, data_axes=tuple(data_axes)
        )


DEFAULT_PLAN = ExecutionPlan()


def reference_plan() -> ExecutionPlan:
    """The bit-exactness oracle: single-pipeline eager torch scatter path."""
    return ExecutionPlan(backend="torch", placement="local", pipelines=1)


def example_plans() -> Tuple[ExecutionPlan, ...]:
    """One representative plan per registered backend, at k = 1, 4, 8.

    The equivalence tests iterate this, so any newly registered backend is
    automatically held to bit-identity with the reference.  (The
    reference's ``mesh`` argument returns with the placement slice.)
    """
    return tuple(
        ExecutionPlan(backend=name, pipelines=k)
        for name in available_backends()
        for k in (1, 4, DEFAULT_PIPELINES)
    )
