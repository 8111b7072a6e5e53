"""Compressed all-reduce over a mesh's positions (wire-format mechanics).

Port of ``repro/optim/compress.py``.  The reference runs an all-reduce
over the data axes under ``shard_map`` whose payload is int8 plus one
float32 scale a shard -- 4x fewer bytes than a float32 psum -- and the
caller's error feedback (``optim/adamw.py``) keeps the accuracy.  The port
follows the single-controller model of ``repro_torch/launch/mesh.py``: one
process holds every position's tensor, quantizes each with
``adamw.quantize_int8``, gathers the int8 payloads and the float32 scales to
the caller's device -- exactly the quantized bytes, which it declares as
the gather's bytes (``repro_torch.obs.costs``) -- and dequantizes and sums
there in float32, so there is no int8 overflow.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from repro_torch.obs import costs
from repro_torch.optim.adamw import quantize_int8


def compressed_gather(xs: Sequence[torch.Tensor], device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payloads (n_positions, ...), float32 scales (n_positions,)) of
    each position's tensor, quantized where it lies and gathered to
    ``device`` (the first tensor's by default)."""
    device = xs[0].device if device is None else torch.device(device)
    qs, ss = [], []
    for i, x in enumerate(xs):
        q, scale = quantize_int8(x)
        if i:
            costs.collective("all-gather", q.numel() + 4)
        qs.append(q.to(device))
        ss.append(scale.to(device))
    return torch.stack(qs), torch.stack(ss)


def compressed_psum(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """All-reduce(sum) in float32 of the positions' tensors ``xs`` with an
    int8 payload on the wire: the reference's ``compressed_psum(x, axis)``
    over the positions of ``axis``, one tensor each, summed on ``device``."""
    qs, ss = compressed_gather(xs, device)
    deq = qs.float() * ss.reshape((-1,) + (1,) * (qs.dim() - 1))
    return torch.sum(deq, dim=0)


def compressed_allreduce_bytes(x: torch.Tensor, n_devices: int) -> dict:
    """Napkin accounting: payload bytes against a float32 psum."""
    n = x.numel()
    return {
        "f32_psum_bytes": 4 * n * 2 * (n_devices - 1) / n_devices,  # ring
        "int8_gather_bytes": (1 * n + 4) * (n_devices - 1),
        "ratio": 4.0,
    }


def make_compressed_grad_reducer(mesh, axes: Sequence[str]):
    """Mean-reduction of a replicated gradient tree over ``axes`` of ``mesh``:
    every position of those axes holds each leaf (the reference's ``P()``
    in-spec), the leaves' compressed sum over the positions is divided by
    the product of the axis sizes, on the caller's device."""
    positions = mesh.shard_devices(tuple(axes))
    count = math.prod(mesh.shape[a] for a in axes)

    def reduce_tree(grads):
        def one(leaf):
            summed = compressed_psum([leaf.to(dev) for dev in positions], leaf.device)
            return summed / torch.tensor(float(count), dtype=torch.float32, device=leaf.device)

        if isinstance(grads, dict):
            return {k: reduce_tree(v) for k, v in grads.items()}
        return None if grads is None else one(grads)

    return reduce_tree
