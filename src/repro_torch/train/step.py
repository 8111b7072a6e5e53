"""The training step: loss + grads + AdamW + the HLL datapath tap.

Port of ``repro/train/step.py``.  The reference jits the step and donates
its state; PyTorch runs eagerly, so ``make_jitted_step`` returns the eager
step (with shardings given, checked against them as jit's ``in_shardings``
check, on the mesh's device) and the step updates its state in place: the model's parameters, the
optimizer's ``mu``, ``nu`` and ``count``, the step counter and the sketch
registers.  The tap runs on the tokens already on the device -- one
``hll_update_fused`` launch on the card (``sketch.dispatch.datapath_tap``)
-- and the in-step estimate is the float32 device finalization.

The state is a dict like the reference's: ``params`` (the
``transformer.Model``, its parameters trainable), ``opt`` (``mu``, ``nu``
keyed by the model's parameter names, ``count``, ``ef``), ``step`` (int32)
and ``sketch`` ((m,) uint8 registers).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch import interop
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.common import scalar
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.sharding import specs as shardspecs
from repro_torch.sketch import estimators, hll
from repro_torch.sketch.dispatch import datapath_tap
from repro_torch.sketch.estimators import DEFAULT_ESTIMATOR
from repro_torch.sketch.hll import HLLConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    sketch: HLLConfig = HLLConfig(p=16, hash_bits=64)
    # phase-4 finalizer for the in-step device estimate and the loop's
    # exact host finalization (repro_torch.sketch.estimators registry)
    sketch_estimator: str = DEFAULT_ESTIMATOR
    aux_weight: float = 0.01  # MoE load-balance loss weight
    sketch_enabled: bool = True
    # gradient accumulation: micro-batches processed sequentially per step,
    # capping live activation memory at (B / grad_accum) sequences' worth
    grad_accum: int = 1


def params_of(model: transformer.Model) -> Dict[str, torch.Tensor]:
    """The model's parameters by name: the trees ``optim.adamw`` works on."""
    return dict(model.named_parameters())


def init_train_state(generator: torch.Generator, arch: ArchConfig, cfg: TrainConfig, device=None) -> dict:
    """A fresh state on ``device`` (the card by default), the weights drawn
    from ``generator``."""
    device = resolve_device(device)
    model = transformer.init_params(arch, generator, device)
    model.requires_grad_(True)
    return {
        "params": model,
        "opt": adamw.init_state(params_of(model)),
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "sketch": hll.init_registers(cfg.sketch, device),
    }


def _micro_batches(batch: dict, n: int, arch: ArchConfig) -> list:
    """The reference's reshape into n micro-batches (M-RoPE positions are
    (3, B, S): split along B)."""
    micro = {
        k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
        if k != "positions" or not arch.mrope
        else v.reshape((3, n, v.shape[1] // n) + tuple(v.shape[2:])).transpose(0, 1)
        for k, v in batch.items()
    }
    return [{k: v[i] for k, v in micro.items()} for i in range(n)]


def train_step(state: dict, batch: dict, arch: ArchConfig, cfg: TrainConfig) -> Tuple[dict, dict]:
    """One step, in place on ``state``; returns (state, metrics)."""
    model = state["params"]
    params = params_of(model)
    leaves = list(params.values())

    def grad_fn(mb):
        loss, parts = transformer.loss_fn(model, mb, arch, cfg.aux_weight)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    if cfg.grad_accum <= 1:
        loss_val, parts, grads = grad_fn(batch)
        grads = dict(zip(params, grads))
    else:
        n = cfg.grad_accum
        dev = state["step"].device
        over_n = scalar(n, dev)
        loss_val = torch.zeros((), dtype=torch.float32, device=dev)
        parts = {"nll": torch.zeros((), device=dev), "aux": torch.zeros((), device=dev)}
        grads = {name: torch.zeros_like(p) for name, p in params.items()}
        for mb in _micro_batches(batch, n, arch):
            l, p, g = grad_fn(mb)
            loss_val = loss_val + l / over_n
            parts = {k: parts[k] + p[k] / over_n for k in parts}
            for acc, gi in zip(grads.values(), g):
                acc.add_(gi.div_(over_n))
            del g
    stacks = list(transformer.stage_stacks(arch, params).values())
    _, opt, opt_metrics = adamw.update(params, grads, state["opt"], cfg.optimizer, stacks)
    del grads

    regs = state["sketch"]
    if cfg.sketch_enabled:
        regs = datapath_tap(regs, batch["tokens"], cfg.sketch)
    distinct = estimators.estimate_device(regs, cfg.sketch, estimator=cfg.sketch_estimator)

    state.update(opt=opt, step=state["step"] + 1, sketch=regs)
    metrics = {
        "loss": loss_val,
        "nll": parts["nll"],
        "aux": parts["aux"],
        "distinct_tokens": distinct,
        **opt_metrics,
    }
    return state, metrics


def make_jitted_step(arch: ArchConfig, cfg: TrainConfig, mesh=None, state_shardings=None,
                     batch_shardings=None):
    """The step with ``arch`` and ``cfg`` bound: the reference's jit with a
    donated state and optional explicit shardings.  PyTorch runs eagerly and
    the step updates in place.

    ``state_shardings`` is the reference-shaped tree of ``NamedSharding``s
    (``params``, ``opt.mu``/``nu``/``count``/``ef``, ``step``, ``sketch``;
    None where unconstrained), ``batch_shardings`` one a batch key.  With them
    given, each call checks every leaf -- a stage's layers stacked, as the
    reference holds them -- against its sharding, raising ValueError where
    jit's ``in_shardings`` raise, and runs on the mesh's device (the
    single-controller model: whole tensors on the caller's device).  The
    reference ignores ``mesh``; so does the port."""
    step = functools.partial(train_step, arch=arch, cfg=cfg)
    if state_shardings is None:
        return step
    device = shardspecs.tree_device(state_shardings)

    def sharded_step(state: dict, batch: dict):
        shardspecs.check_tree(interop.meta_tree(interop.train_state_leaves(state)), state_shardings, "state")
        if batch_shardings is not None:
            shardspecs.check_tree(batch, batch_shardings, "batch")
        if shardspecs.canonical_device(state["step"].device) != device:
            raise ValueError(f"the state lies on {state['step'].device}, its shardings on {device}: "
                             "place it there first (checkpoint.ckpt.restore takes shardings)")
        return step(state, {k: v.to(device) for k, v in batch.items()})

    return sharded_step
