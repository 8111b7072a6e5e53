"""Activation-sharding hints: the constraints a sharded program places.

Port of ``repro/sharding/ctx.py``.  The reference's models place
``with_sharding_constraint`` at the head/channel-forming reshapes, where
XLA's propagation would otherwise lose the 'model' sharding, resolved
through these hints so the same model code runs unsharded (hints unset)
and on any mesh the launcher picks.  The port's models call ``constrain``
at the same sites.  The port runs one process and holds whole tensors (the
single-controller model of ``repro_torch/launch/mesh.py``), so a
constraint changes no value, as a constraint on one device changes none in
jax: ``constrain`` resolves the spec the reference would, checks it against
the value's rank, and returns the value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.sharding.specs import PartitionSpec


@dataclasses.dataclass(frozen=True)
class ActivationHints:
    batch_axes: Tuple[str, ...]  # () to leave batch unsharded
    model_axis: Optional[str]  # None to leave features unsharded
    # Korthikanti-style sequence parallelism: the residual stream between
    # layers is sharded over the model axis on its sequence dim
    seq_parallel: bool = False


_HINTS: Optional[ActivationHints] = None


def set_hints(hints: Optional[ActivationHints]) -> None:
    global _HINTS
    _HINTS = hints


def get_hints() -> Optional[ActivationHints]:
    return _HINTS


class use_hints:
    """Context manager for scoped hints (used by the dry-run launcher)."""

    def __init__(self, hints: Optional[ActivationHints]):
        self.hints = hints
        self.prev = None

    def __enter__(self):
        global _HINTS
        self.prev = _HINTS
        _HINTS = self.hints
        return self.hints

    def __exit__(self, *exc):
        global _HINTS
        _HINTS = self.prev
        return False


def resolve(dims: Tuple[Optional[str], ...], hints: ActivationHints) -> PartitionSpec:
    """The spec ``dims`` ('batch' | 'model' | None, one per dim) resolve to
    under ``hints``; an axis the hints leave out resolves to None."""
    spec = []
    for d in dims:
        if d == "batch" and hints.batch_axes:
            spec.append(hints.batch_axes if len(hints.batch_axes) > 1 else hints.batch_axes[0])
        elif d == "model" and hints.model_axis:
            spec.append(hints.model_axis)
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def constrain(x, dims: Tuple[Optional[str], ...]):
    """The sharding constraint resolved from hints, on one process.

    The identity when hints are unset.  With hints set, ``dims`` may name
    no more entries than ``x`` has dims (ValueError otherwise, where jax
    raises on the spec's rank); the value passes through unchanged.
    """
    h = _HINTS
    if h is None:
        return x
    spec = resolve(dims, h)
    if len(spec) > x.dim():
        raise ValueError(f"constraint {spec} is for rank {len(spec)}, got shape {tuple(x.shape)}")
    return x
