"""ExecutionPlan: config-driven dispatch for the sketch aggregation phase.

Port of ``repro/sketch/plan.py`` with all seven of its registry axes:
single-sketch ingest, bank ingest, the window ring fold, the incremental
window merge, the HybridBank sparse dedup, and the count-min pair (ingest
+ point query) and count-min ring fold.  The backends:

  backend    "torch"            eager PyTorch scatter-max, on the CPU or
                                the card (the reference's "jnp")
             "cuda"             the fused CUDA kernel: hash, rank and
                                register max in one launch, registers in
                                shared memory (the reference's "pallas")
             "cuda_pipelined"   k fused CUDA launches + the bucket-fold
                                kernel (paper Fig. 3 built from kernels;
                                the reference's "pallas_pipelined")
  placement  "local"            one device
             "mesh"             items sharded over ``data_axes`` of ``mesh``
                                (``repro_torch.launch.mesh.Mesh``); each
                                shard's partial state is folded by max onto
                                the caller's device
             "sharded"          the BANK'S ROW AXIS sharded over ``data_axes``
                                of ``mesh`` (DESIGN.md §16): every shard owns
                                a block of tenant rows, the keyed stream is
                                re-based into block-local coordinates and the
                                §9 drop rule discards foreign keys -- routing
                                without a collective.  Surfaces with no row
                                axis (single-sketch updates, count-min ingest)
                                degrade to the mesh stream-sharding rule,
                                which is bit-identical by the same lattice
                                laws.
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
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics
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

# backend name -> fn(ring_registers, mask, cfg, plan) -> (B, m) registers.
# Windowed folds collapse the (W, B, m) ring of a WindowedBank into one
# scratch bank with a single masked max-reduce (DESIGN.md §11); the (W,)
# mask lies on the ring's device.
_WINDOW_BACKENDS: Dict[str, Callable] = {}

# backend name -> fn(parts, cfg, plan) -> (B, m) registers.
# The read side of the incremental window decomposition (DESIGN.md §14):
# ``parts`` is a tiny (K, B, m) stack of already-folded fragments (prefix
# top, suffix accumulator, dirty head bucket) merged by max.
_WINDOW_MERGE_BACKENDS: Dict[str, Callable] = {}


class SparseDedup(NamedTuple):
    """Canonical dedup of a (row, bucket, rank) triple stream (DESIGN.md §12).

    A sparse backend answers "what is each row's distinct bucket -> max-rank
    map" for the HybridBank compaction step, in one of two layouts (both
    enumerate every live row's buckets in ascending order, so the compacted
    COO pairs, promoted registers and distinct counts derived from either
    are bit-identical):

    * **sorted stream** (``cells=None``): ``cell_s`` holds ``row*m + bucket``
      ids sorted ascending with dropped entries at a trailing sentinel,
      ``rank_s`` the co-sorted ranks, and ``survivor`` marks the last
      (max-rank) entry of each live cell run -- the argsort form, which
      wins when the stream is small next to the bank.
    * **dense cells** (``cells`` set): ``cells`` is the (rows, m) int32
      max-rank map itself (0 = untouched bucket) and the stream fields are
      None -- the scatter form (a scatter-amax, or the sparse_scatter CUDA
      kernel), which wins once the stream rivals the bank's cell count.

    ``distinct`` is always the (rows,) int32 per-row distinct-bucket count.
    """

    distinct: Any
    cells: Optional[Any] = None
    cell_s: Optional[Any] = None
    rank_s: Optional[Any] = None
    survivor: Optional[Any] = None


class CMBackend(NamedTuple):
    """The count-min backend pair: fused ingest + batched point query.

    ingest: fn(counters, keys, flat_items, cfg, plan) -> (B, d, w) counters
    query:  fn(counters, flat_items, cfg, plan) -> (B, n) int64 counts

    Counters are int32 tensors holding the uint32 bits; a query returns the
    uint32 values in int64.
    """

    ingest: Callable
    query: Callable


# backend name -> CMBackend.  The count-min family (DESIGN.md §13)
# registers under the SAME names as the HLL axes, so one ExecutionPlan
# drives cardinality and heavy-hitter sketches alike.
_CM_BACKENDS: Dict[str, CMBackend] = {}

# backend name -> fn(ring_counters, mask, cfg, plan) -> (B, d, w) counters.
# Windowed count-min folds collapse the (W, B, d, w) counter ring with one
# masked SUM-reduce (the additive mirror of the window fold above).
_CM_WINDOW_BACKENDS: Dict[str, Callable] = {}


# backend name -> fn(row, bucket, rank, rows, cfg, plan) -> SparseDedup.
# The HybridBank append-buffer compaction (DESIGN.md §12) dispatches its
# dedup through this axis.
_SPARSE_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register an aggregation backend under ``name``."""

    def deco(fn: Callable) -> Callable:
        if name in _BACKENDS:
            raise ValueError(f"backend {name!r} already registered")
        # every axis wraps at registration so per-backend dispatch counts
        # and wall time (DESIGN.md §15) cost one flag check when disabled;
        # short-circuits (empty streams) never reach the wrapper, so they
        # are never counted
        _BACKENDS[name] = obs_metrics.wrap_backend("update", name, fn)
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
        _BANK_BACKENDS[name] = obs_metrics.wrap_backend("bank_update", name, fn)
        return fn

    return deco


def register_window_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a windowed ring-fold path under ``name``.

    The signature is fn(ring_registers, mask, cfg, plan) -> (B, m)
    registers, where ``ring_registers`` is the (W, B, m) ring of a
    ``WindowedBank`` and ``mask`` a (W,) bool on its device selecting the
    live buckets.  Every entry must be bit-identical to merging the live
    buckets one by one.  A backend without a window entry still works for
    flat plans; ``estimate_window`` raises a targeted error for it.
    """

    def deco(fn: Callable) -> Callable:
        if name in _WINDOW_BACKENDS:
            raise ValueError(f"window backend {name!r} already registered")
        _WINDOW_BACKENDS[name] = obs_metrics.wrap_backend("window_fold", name, fn)
        return fn

    return deco


def register_window_merge_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register an incremental window-merge path under ``name``.

    The signature is fn(parts, cfg, plan) -> (B, m) registers, where
    ``parts`` is a (K, B, m) stack of fold fragments (DESIGN.md §14).
    Entries must be bit-identical to ``torch.amax(parts, 0)``.  A backend
    needs no entry of its own to stay incremental-capable:
    ``get_window_merge_backend`` falls back to the torch merge, which is
    exact for any fragment grouping by the max-lattice laws (DESIGN.md §6).
    """

    def deco(fn: Callable) -> Callable:
        if name in _WINDOW_MERGE_BACKENDS:
            raise ValueError(f"window merge backend {name!r} already registered")
        _WINDOW_MERGE_BACKENDS[name] = obs_metrics.wrap_backend("window_merge", name, fn)
        return fn

    return deco


def register_cm_backend(name: str, ingest: Callable, query: Callable) -> CMBackend:
    """Register a count-min backend pair (fused ingest + point query).

    Unlike the single-function axes, a count-min backend is a PAIR -- the
    scatter-add ingest and the gather-min query -- so registration is a
    plain call rather than a decorator.  Signatures are documented on
    :class:`CMBackend`.  Every registered ingest must be bit-identical to
    the torch entry.
    """
    if name in _CM_BACKENDS:
        raise ValueError(f"cm backend {name!r} already registered")
    backend = CMBackend(
        obs_metrics.wrap_backend("cm_update", name, ingest),
        obs_metrics.wrap_backend("cm_query", name, query),
    )
    _CM_BACKENDS[name] = backend
    return backend


def register_cm_window_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a windowed count-min ring-fold path under ``name``.

    The signature is fn(ring_counters, mask, cfg, plan) -> (B, d, w)
    counters, where ``ring_counters`` is the (W, B, d, w) int32 ring of a
    ``WindowedCountMinBank`` and ``mask`` a (W,) bool on its device
    selecting the live buckets.  Every entry must be bit-identical to
    summing the live buckets one by one, mod 2^32.
    """

    def deco(fn: Callable) -> Callable:
        if name in _CM_WINDOW_BACKENDS:
            raise ValueError(f"cm window backend {name!r} already registered")
        _CM_WINDOW_BACKENDS[name] = obs_metrics.wrap_backend("cm_window_fold", name, fn)
        return fn

    return deco


def register_sparse_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a HybridBank dedup/compaction path under ``name``.

    The signature is fn(row, bucket, rank, rows, cfg, plan) ->
    :class:`SparseDedup`, where the int32 triple tensors carry the combined
    live-pair + append-buffer stream (entries with ``row`` outside
    [0, rows) are padding and must not survive).  Every entry must produce
    compacted pairs, promoted registers and distinct counts bit-identical
    to the torch entry.
    """

    def deco(fn: Callable) -> Callable:
        if name in _SPARSE_BACKENDS:
            raise ValueError(f"sparse backend {name!r} already registered")
        _SPARSE_BACKENDS[name] = obs_metrics.wrap_backend("sparse_dedup", name, fn)
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


def get_window_backend(name: str) -> Callable:
    try:
        return _WINDOW_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"backend {name!r} has no window fold path; window-capable: "
            f"{sorted(_WINDOW_BACKENDS)}"
        ) from None


def get_window_merge_backend(name: str) -> Callable:
    """The incremental merge entry for ``name``, or the torch fallback.

    This axis never raises for an unregistered name: fold fragments merge
    exactly under the torch max-reduce whatever backend produced them.
    Every built-in backend ("torch", "cuda", "cuda_pipelined") registers
    its own entry, so the fallback serves only plugin backends.
    """
    fn = _WINDOW_MERGE_BACKENDS.get(name)
    if fn is not None:
        return fn
    try:
        return _WINDOW_MERGE_BACKENDS["torch"]
    except KeyError:  # pragma: no cover - backends.py always registers torch
        raise ValueError("no window merge backends registered") from None


def get_cm_backend(name: str) -> CMBackend:
    try:
        return _CM_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"backend {name!r} has no count-min path; cm-capable: "
            f"{sorted(_CM_BACKENDS)}"
        ) from None


def get_cm_window_backend(name: str) -> Callable:
    try:
        return _CM_WINDOW_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"backend {name!r} has no count-min window fold path; "
            f"cm-window-capable: {sorted(_CM_WINDOW_BACKENDS)}"
        ) from None


def get_sparse_backend(name: str) -> Callable:
    try:
        return _SPARSE_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"backend {name!r} has no sparse dedup path; sparse-capable: "
            f"{sorted(_SPARSE_BACKENDS)}"
        ) from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def available_bank_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BANK_BACKENDS))


def available_window_backends() -> Tuple[str, ...]:
    return tuple(sorted(_WINDOW_BACKENDS))


def available_window_merge_backends() -> Tuple[str, ...]:
    return tuple(sorted(_WINDOW_MERGE_BACKENDS))


def available_cm_backends() -> Tuple[str, ...]:
    return tuple(sorted(_CM_BACKENDS))


def available_cm_window_backends() -> Tuple[str, ...]:
    return tuple(sorted(_CM_WINDOW_BACKENDS))


def available_sparse_backends() -> Tuple[str, ...]:
    return tuple(sorted(_SPARSE_BACKENDS))


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
    # storage hint for hybrid carriers (DESIGN.md §12): rows of a
    # HybridBank built under this plan promote from the sparse COO layout
    # to dense registers once their distinct-bucket count exceeds this.
    # None defers to the carrier default (m // 4); the carrier re-validates
    # against its config (must stay <= m // 2 for the LC-regime guarantee).
    sparse_threshold: Optional[int] = None

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"placement must be one of {PLACEMENTS}, got {self.placement!r}"
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
        if self.placement in ("mesh", "sharded") and self.mesh is None:
            raise ValueError(f"placement={self.placement!r} requires a mesh")
        object.__setattr__(self, "data_axes", tuple(self.data_axes))

    def validate(self) -> "ExecutionPlan":
        """Check backend + estimator exist (deferred so plans build early)."""
        get_backend(self.backend)
        get_estimator(self.estimator)
        if self.placement in ("mesh", "sharded"):
            missing = set(self.data_axes) - set(self.mesh.axis_names)
            if missing:
                raise ValueError(
                    f"data_axes {sorted(missing)} not in mesh axes "
                    f"{self.mesh.axis_names}"
                )
        return self

    def with_mesh(self, mesh, data_axes=("data",)) -> "ExecutionPlan":
        return dataclasses.replace(
            self, placement="mesh", mesh=mesh, data_axes=tuple(data_axes)
        )

    def with_sharding(self, mesh, data_axes=("data",)) -> "ExecutionPlan":
        """Row-sharded placement (DESIGN.md §16): bank rows over ``mesh``."""
        return dataclasses.replace(
            self, placement="sharded", mesh=mesh, data_axes=tuple(data_axes)
        )


DEFAULT_PLAN = ExecutionPlan()


def reference_plan() -> ExecutionPlan:
    """The bit-exactness oracle: single-pipeline eager torch scatter path."""
    return ExecutionPlan(backend="torch", placement="local", pipelines=1)


def example_plans(mesh=None) -> Tuple[ExecutionPlan, ...]:
    """One representative plan per registered backend (x placements).

    The equivalence tests iterate this, so any newly registered backend is
    automatically held to bit-identity with the reference.
    """
    plans = []
    for name in available_backends():
        for k in (1, 4, DEFAULT_PIPELINES):
            plans.append(ExecutionPlan(backend=name, pipelines=k))
        if mesh is not None:
            plans.append(ExecutionPlan(backend=name, pipelines=2).with_mesh(mesh))
    return tuple(plans)
