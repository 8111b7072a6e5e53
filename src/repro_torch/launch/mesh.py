"""Device meshes for the sketch placements (port of ``repro/launch/mesh.py``).

A ``Mesh`` names the axes of a grid of ``torch.device`` positions.  The
reference's mesh is a ``jax.sharding.Mesh`` that ``shard_map`` runs over
inside one process; the port keeps that single-controller model: the
placement rules of ``repro_torch/sketch/dispatch.py`` run each shard on its
position's device from the one calling process and fold the results there,
so every carrier call returns the whole state to its caller, as the
reference's replicated outputs do.

A device list may repeat a device.  That is the port's counterpart of the
reference tests' ``--xla_force_host_platform_device_count``: four shards
on one CPU, or four row blocks on one card.

Functions, not module constants: importing this module touches no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.sketch.hll import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a row-major tuple of devices.  Hashable, so plans
    that hold one stay hashable."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_sizes", tuple(int(s) for s in self.axis_sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} axis sizes for axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1, got {self.axis_sizes}")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(
                f"a {self.axis_sizes} mesh needs {math.prod(self.axis_sizes)} devices, "
                f"got {len(self.devices)}"
            )

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def shard_devices(self, data_axes: Sequence[str]) -> Tuple[torch.device, ...]:
        """One device per shard over ``data_axes``, in the row-major order
        of those axes (the order ``PartitionSpec(axes)`` shards by); the
        other axes replicate, so each shard takes their first position."""
        sizes = self.shape
        out = []
        for shard in range(math.prod(sizes[a] for a in data_axes)):
            coord = dict.fromkeys(self.axis_names, 0)
            for a in reversed(tuple(data_axes)):
                shard, coord[a] = divmod(shard, sizes[a])
            flat = 0
            for name, size in zip(self.axis_names, self.axis_sizes):
                flat = flat * size + coord[name]
            out.append(self.devices[flat])
        return tuple(out)


def make_auto_mesh(shape, axes, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ``devices``: by default every
    visible CUDA device (raising when there is none), which the shape must
    cover exactly, as ``jax.make_mesh`` requires."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(tuple(shape), tuple(axes), tuple(devices))


def local_devices(device=None) -> Tuple[torch.device, ...]:
    """The process's devices of ``device``'s kind (the card by default), as
    ``jax.devices()`` lists them: every visible card, or the one CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (device,)


def make_production_mesh(*, multi_pod: bool = False, tp: int = 16, devices: Optional[Sequence] = None) -> Mesh:
    """The (256 // tp, tp) mesh on ("data", "model"), or with ``multi_pod``
    the (2, 256 // tp, tp) mesh on ("pod", "data", "model").  ``tp`` other
    than 16 refactors the same 256 positions a pod into data x model.

    By default every position is the card (raising when there is none), as
    ``make_test_mesh`` puts them: the dry-run asks what each position would
    hold, and the sketch roofline runs all of them from one process."""
    data = 256 // tp
    shape = (2, data, tp) if multi_pod else (data, tp)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        devices = [resolve_device(None)] * math.prod(shape)
    return make_auto_mesh(shape, axes, devices)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device=None) -> Mesh:
    """A small mesh with every position on one device (the card by
    default; ``device="cpu"`` for the CPU tests)."""
    dev = resolve_device(device)
    return make_auto_mesh(shape, axes, [dev] * math.prod(shape))


def n_chips(mesh: Mesh) -> int:
    """Mesh positions, as the reference's ``mesh.devices.size`` (a repeated
    device counts once per position)."""
    return len(mesh.devices)
