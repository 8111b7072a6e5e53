"""AdamW + schedule + clipping + int8 error-feedback compression.

Port of ``repro/optim/adamw.py``, on flat parameter trees: dicts of
tensors keyed by a model's parameter names (``dict(model.named_parameters())``),
with the optimizer state mirroring them -- float32 ``mu`` and ``nu`` per
parameter, an int32 ``count``, and ``ef`` (the error-feedback residuals,
None until the first compressed step).

The arithmetic follows the reference's order of operations, and divides
by float32 0-dim tensors (``models.common.scalar``), never by Python
numbers (ROADMAP C, "Models").  It cannot be bit-identical to the jitted
reference all the same: XLA's CPU compiler contracts ``a * b + c`` into a
fused multiply-add, turns a division by a constant into a product with its
reciprocal, and its ``cos`` and ``pow`` round otherwise than ATen's (ROADMAP
C.4).  The tests state the bounds: ``schedule`` within a few float32 ulps,
the parameters after an update within a few ulps, not growing over steps.

The port updates in place where the reference returns new trees (its
step donates them): ``clip_by_global_norm`` scales the gradients it is
given, and ``update`` writes the parameters, ``mu``, ``nu``, ``count`` and
``ef`` of the state it is given and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.common import scalar

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False  # int8 + error feedback


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio; float32 on step's device."""
    dev = step.device
    step = step.to(torch.float32)
    warm = step / scalar(max(1.0, cfg.warmup_steps), dev)
    t = (step - cfg.warmup_steps) / scalar(max(1.0, cfg.total_steps - cfg.warmup_steps), dev)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: Tree) -> dict:
    device = next(iter(params.values())).device
    return {
        "mu": {name: torch.zeros_like(p) for name, p in params.items()},
        "nu": {name: torch.zeros_like(p) for name, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "ef": None,  # error-feedback residuals, created lazily on compression
    }


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.float())) for leaf in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(scalar(max_norm, norm.device) / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm


# ----------------------------------------------------------------------------
# int8 error-feedback compression
# ----------------------------------------------------------------------------


def _int8_scale(tensors) -> torch.Tensor:
    """The symmetric int8 scale of float32 tensors quantized as one."""
    peak = torch.max(torch.stack([torch.max(torch.abs(x)) for x in tensors]))
    return peak / scalar(127.0, peak.device) + 1e-12


def _int8(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale float32 0-dim)."""
    xf = x.float()
    scale = _int8_scale([xf])
    return _int8(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_error_feedback(grads: Tree, ef_residuals: Optional[Tree],
                                 stacks: Optional[List[List[str]]] = None) -> Tuple[Tree, Tree]:
    """Quantize grads to int8, carrying quantization error to the next step.

    The scale is per tensor of the reference's tree: ``stacks`` lists the
    names that the reference holds as one leaf stacked over a stage's layers
    (the values of ``transformer.stage_stacks``), which share one scale; any
    other parameter is a tensor of its own.
    """
    if ef_residuals is None:
        ef_residuals = {name: torch.zeros_like(g, dtype=torch.float32) for name, g in grads.items()}
    stacked = {name for names in stacks or () for name in names}
    groups = list(stacks or ()) + [[name] for name in grads if name not in stacked]
    new_grads, new_ef = {}, {}
    for names in groups:
        corrected = [grads[name].float() + ef_residuals[name] for name in names]
        scale = _int8_scale(corrected)
        for name, c in zip(names, corrected):
            deq = dequantize_int8(_int8(c, scale), scale)
            new_grads[name], new_ef[name] = deq.to(grads[name].dtype), c - deq
    return {name: new_grads[name] for name in grads}, {name: new_ef[name] for name in grads}


# ----------------------------------------------------------------------------
# update
# ----------------------------------------------------------------------------


def decays(name: str, p: torch.Tensor, stacked) -> bool:
    """Whether ``p`` takes weight decay: the reference decays the leaves of
    its tree with ndim >= 2, and a leaf it stacks over a stage's layers
    (``stacked``: the names listed in ``update``'s ``stacks``) has one ndim
    more than each layer's tensor."""
    return p.ndim >= 2 or name in stacked


def update(params: Tree, grads: Tree, opt_state: dict, cfg: OptimizerConfig,
           stacks: List[List[str]]) -> Tuple[Tree, dict, dict]:
    """One AdamW step, in place. Returns (params, opt_state, metrics).
    ``stacks``: the names that the reference holds as one leaf stacked over
    a stage's layers (the values of ``transformer.stage_stacks``); they set
    the decay (``decays``) and the compression's shared scales
    (``compress_with_error_feedback``)."""
    grads, grad_norm = clip_by_global_norm(grads, cfg.clip_norm)

    ef = opt_state.get("ef")
    if cfg.compress_grads:
        grads, ef = compress_with_error_feedback(grads, ef, stacks)

    stacked = {name for names in stacks for name in names}
    count = opt_state["count"] + 1
    lr = schedule(cfg, count)
    dev = count.device
    b1c = 1 - torch.pow(scalar(cfg.b1, dev), count.to(torch.float32))
    b2c = 1 - torch.pow(scalar(cfg.b2, dev), count.to(torch.float32))

    with torch.no_grad():
        for name, p in params.items():
            gf = grads[name].float()
            mu, nu = opt_state["mu"][name], opt_state["nu"][name]
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
            upd = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
            if decays(name, p, stacked):
                upd = upd + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
    opt_state.update(count=count, ef=ef)
    return params, opt_state, {"lr": lr, "grad_norm": grad_norm}
