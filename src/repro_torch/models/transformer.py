"""Decoder backbone assembly: stages, parameters and the full-sequence forward.

Port of ``repro/models/transformer.py`` for every family:

  dense / moe / audio / vlm : attention mixer (+SWA / M-RoPE / qk-norm),
                              a SwiGLU or MoE channel mix
  ssm (rwkv6)               : RWKV6 time-mix + squared-ReLU channel mix
  hybrid (recurrentgemma)   : (rec, rec, attn) pattern, RG-LRU + local attn

Layers are grouped into *stages* -- (pattern, repeats) pairs -- as in the
reference; hybrids repeat whole patterns and leftover layers form a
trailing mini-stage.  The reference scans each stage over stacked
parameters, the port keeps one ``Block`` per sublayer in a flat layer
list, in stage order, and runs them in a Python loop.

Training: ``loss_fn`` is the reference's next-token loss.  The parameters
are registered frozen (``requires_grad=False``) for serving, which runs
under ``torch.inference_mode()``; ``train.step.init_train_state`` makes
them trainable.  With a trainable model and grad mode on, ``forward``
recomputes each stage's layer body in the backward pass
(``torch.utils.checkpoint``, non-reentrant), the boundary at which the
reference checkpoints its scanned body (``jax.checkpoint(body)``).

Modality frontends (audio frames / vision patches) are stubs, as in the
reference: ``frontend_embeds`` enter as precomputed (B, stub_len, d)
activations that overwrite the leading token embeddings.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, common, moe, rglru, rwkv6
from repro_torch.sharding import ctx as shardctx
from repro_torch.sketch.hll import resolve_device


# ----------------------------------------------------------------------------
# stage structure
# ----------------------------------------------------------------------------


def layer_stages(arch: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(sublayer pattern, repeats)] covering exactly n_layers layers."""
    if arch.block_pattern is None:
        kind = "rwkv" if arch.mixer == "rwkv6" else "attn"
        return [((kind,), arch.n_layers)]
    pat = tuple(arch.block_pattern)
    full = arch.n_layers // len(pat)
    rem = arch.n_layers - full * len(pat)
    stages: List[Tuple[Tuple[str, ...], int]] = [(pat, full)]
    if rem:
        stages.append((tuple(pat[:rem]), 1))
    return stages


def sublayers(arch: ArchConfig) -> List[Tuple[int, int, int, str]]:
    """(stage, repeat, sub, kind) of every sublayer, in the layer list's order."""
    return [
        (si, rep, j, kind)
        for si, (pattern, repeats) in enumerate(layer_stages(arch))
        for rep in range(repeats)
        for j, kind in enumerate(pattern)
    ]


def stage_stacks(arch: ArchConfig, names) -> Dict[Tuple[str, ...], List[str]]:
    """{key path of a leaf the reference stacks over a stage's layers (for
    example ``("stage0", "sub0", "mixer", "wq")``): the names among ``names``
    (``layers.<i>.<part>.<name>``) of the port's per-layer tensors it
    stacks, in layer order}."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, (si, _, j, _) in enumerate(sublayers(arch)):
        groups.setdefault((si, j), []).append(i)
    stacks = {}
    for (si, j), layers in groups.items():
        prefix = f"layers.{layers[0]}."
        for key in (name[len(prefix):] for name in names if name.startswith(prefix)):
            stacks[(f"stage{si}", f"sub{j}", *key.split("."))] = [f"layers.{i}.{key}" for i in layers]
    return stacks


def _sublayer_window(kind: str, arch: ArchConfig) -> Optional[int]:
    if arch.block_pattern is not None and kind == "attn":
        return arch.local_window
    return arch.sliding_window


_MIXERS = {"attn": (attention.param_shapes, attention.init_params, attention.Attention),
           "rec": (rglru.param_shapes, rglru.init_params, rglru.RGLRU),
           "rwkv": (rwkv6.param_shapes, rwkv6.init_params, rwkv6.TimeMix)}


def _parts(kind: str, arch: ArchConfig):
    """(param_shapes, init_params, module) of a ``kind`` sublayer's mixer and
    of its channel mix: MoE for a MoE arch, else RWKV6's or a SwiGLU."""
    if kind not in _MIXERS:
        raise ValueError(f"unknown sublayer kind {kind!r}")
    if arch.moe is not None:
        channel = (moe.param_shapes, moe.init_params, moe.MoE)
    elif kind == "rwkv":
        channel = (rwkv6.channel_param_shapes, rwkv6.init_channel_params, rwkv6.ChannelMix)
    else:
        channel = (lambda a: common.swiglu_shapes(a.d_model, a.d_ff),
                   lambda a, gen, dev: common.swiglu_init(gen, a.d_model, a.d_ff, dev), common.SwiGLU)
    return _MIXERS[kind], channel


def _part_shapes(kind: str, arch: ArchConfig) -> Dict[str, Dict[str, tuple]]:
    """The mixer's and the channel mix's parameter shapes of a ``kind`` sublayer."""
    mixer, channel = _parts(kind, arch)
    return {"mixer": mixer[0](arch), "channel": channel[0](arch)}


def make_parts(kind: str, arch: ArchConfig, mixer: Dict[str, torch.Tensor], channel: Dict[str, torch.Tensor]):
    """The mixer and channel-mix modules of a ``kind`` sublayer from their tensors."""
    mixer_part, channel_part = _parts(kind, arch)
    return mixer_part[2](mixer), channel_part[2](channel)


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------


class Block(nn.Module):
    """One pre-norm residual sublayer: two norms, a mixer, a channel mix."""

    def __init__(self, kind: str, norm1: torch.Tensor, norm2: torch.Tensor,
                 mixer: common.Params, channel: common.Params):
        super().__init__()
        self.kind = kind
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.norm2 = nn.Parameter(norm2, requires_grad=False)
        self.mixer = mixer
        self.channel = channel


class Model(nn.Module):
    """Embedding, the layer list (stage order), final norm and LM head, and
    the ``arch`` they were built for (its stages group the layers)."""

    def __init__(self, arch: ArchConfig, embed: torch.Tensor, final_norm: torch.Tensor, layers: List[Block],
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.arch = arch
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head, requires_grad=False)


def param_shapes(arch: ArchConfig) -> Dict[str, object]:
    """The reference's parameter tree as shapes, per stage stacked over repeats."""
    d = arch.d_model
    shapes: Dict[str, object] = {"embed": (arch.vocab_size, d), "final_norm": (d,)}
    if not arch.tie_embeddings:
        shapes["lm_head"] = (d, arch.vocab_size)
    for si, (pattern, repeats) in enumerate(layer_stages(arch)):
        def stacked(tree):
            return {name: (repeats, *shape) for name, shape in tree.items()}

        shapes[f"stage{si}"] = {
            f"sub{j}": {
                "norm1": (repeats, d), "norm2": (repeats, d),
                **{part: stacked(tree) for part, tree in _part_shapes(kind, arch).items()},
            }
            for j, kind in enumerate(pattern)
        }
    return shapes


def init_params(arch: ArchConfig, generator: torch.Generator, device=None) -> Model:
    """The full model, drawn from ``generator`` on ``device`` (the card by default)."""
    device = resolve_device(device)
    d = arch.d_model
    embed = common.embed_init(generator, arch.vocab_size, d, device)
    lm_head = None if arch.tie_embeddings else common.dense_init(generator, d, arch.vocab_size, device)
    layers = []
    for _, _, _, kind in sublayers(arch):
        ones = torch.ones((d,), dtype=common.PARAM_DTYPE, device=device)
        mixer_part, channel_part = _parts(kind, arch)
        mixer = mixer_part[1](arch, generator, device)
        channel = channel_part[1](arch, generator, device)
        layers.append(Block(kind, ones, ones.clone(), *make_parts(kind, arch, mixer, channel)))
    return Model(arch, embed, torch.ones((d,), dtype=common.PARAM_DTYPE, device=device), layers, lm_head)


# ----------------------------------------------------------------------------
# forward (prefill)
# ----------------------------------------------------------------------------


def _apply_sublayer(kind: str, sub: Block, x: torch.Tensor, positions, arch: ArchConfig,
                    collect_state: bool):
    """Pre-norm residual sublayer. Returns (x, aux_loss, state_or_None)."""
    h = common.rms_norm(x, sub.norm1, arch.norm_eps)
    state = None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "attn":
        # one projection serves the attention and the prefill's K/V cache
        q, k, v = attention.qkv_project(sub.mixer, h, arch)
        q, k = attention.apply_positions(q, k, positions, arch)
        mixed = attention.attend(sub.mixer, q, k, v, positions, arch, window=_sublayer_window(kind, arch))
        if collect_state:
            state = {"k": k, "v": v}
    elif kind == "rec":
        if collect_state:
            mixed, rec_state = rglru.block(sub.mixer, h, arch, return_state=True)
            state = {"conv": rec_state.conv, "h": rec_state.h}
        else:
            mixed = rglru.block(sub.mixer, h, arch)
    else:  # rwkv
        if arch.rwkv_chunk_size > 0:
            mixed, rwkv_state = rwkv6.time_mix_chunked(sub.mixer, h, arch, chunk=arch.rwkv_chunk_size)
        else:
            mixed, rwkv_state = rwkv6.time_mix(sub.mixer, h, arch)
        if collect_state:
            state = {"s": rwkv_state, "x_prev": h[:, -1]}
    x = x + mixed

    h2 = common.rms_norm(x, sub.norm2, arch.norm_eps)
    if arch.moe is not None:
        ch, aux, _ = moe.moe_mixer(sub.channel, h2, arch)
    elif kind == "rwkv":
        ch = rwkv6.channel_mix(sub.channel, h2)
        if collect_state:
            state = dict(state, cm_x_prev=h2[:, -1])
    else:
        ch = common.swiglu(sub.channel, h2)
    out = x + ch
    hints = shardctx.get_hints()
    if hints is not None and hints.seq_parallel:
        out = shardctx.constrain(out, ("batch", "model", None))
    return out, aux, state


def embed_tokens(model: Model, batch, arch: ArchConfig) -> torch.Tensor:
    tokens = batch["tokens"]
    x = model.embed[tokens.long()].to(common.ACT_DTYPE)
    if arch.frontend_stub_len > 0 and "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(common.ACT_DTYPE)
        stub = fe.shape[1]
        x = torch.cat([fe, x[:, stub:]], dim=1)
    return x


def default_positions(arch: ArchConfig, batch_size: int, seq: int, device=None) -> torch.Tensor:
    """(B, S) int32 positions, (3, B, S) for M-RoPE, on ``device`` (the card by default)."""
    pos = torch.arange(seq, dtype=torch.int32, device=resolve_device(device)).expand(batch_size, seq)
    if arch.mrope:
        return pos.expand(3, batch_size, seq)
    return pos


def _head(model: Model, arch: ArchConfig, dtype: torch.dtype) -> torch.Tensor:
    return (model.embed.T if arch.tie_embeddings else model.lm_head).to(dtype)


def _stage_body(pattern, blocks, x, total_aux, positions, arch: ArchConfig, collect_state: bool):
    """One repeat of a stage: its pattern's sublayers in order.  Returns (x,
    the running aux loss, {sub<j>: state})."""
    states = {}
    for j, (kind, block) in enumerate(zip(pattern, blocks)):
        x, aux_j, st = _apply_sublayer(kind, block, x, positions, arch, collect_state)
        total_aux = total_aux + aux_j
        states[f"sub{j}"] = st
    return x, total_aux, states


def _recomputes(model: Model, collect_state: bool) -> bool:
    """Whether ``forward`` checkpoints its stage bodies: when it builds a
    graph for a trainable model."""
    return torch.is_grad_enabled() and model.embed.requires_grad and not collect_state


def forward(model: Model, batch, arch: ArchConfig, *, collect_state: bool = False):
    """Full-sequence forward.

    Returns (logits (B, S, V), aux_loss, states) -- states is a per-stage
    list of sublayer caches stacked over the stage's layers when
    collect_state (prefill), else None.
    """
    x = embed_tokens(model, batch, arch)
    b, s, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(arch, b, s, x.device)

    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    all_states = [] if collect_state else None
    recompute = _recomputes(model, collect_state)
    layer = iter(model.layers)
    for pattern, repeats in layer_stages(arch):
        per_layer = []
        for _ in range(repeats):
            blocks = [next(layer) for _ in pattern]
            if recompute:
                x, total_aux = checkpoint(
                    lambda xc, aux, blocks=blocks, pattern=pattern:
                        _stage_body(pattern, blocks, xc, aux, positions, arch, False)[:2],
                    x, total_aux, use_reentrant=False)
            else:
                x, total_aux, states = _stage_body(pattern, blocks, x, total_aux, positions, arch, collect_state)
                per_layer.append(states)
        if collect_state:
            all_states.append({
                f"sub{j}": {key: torch.stack([st[f"sub{j}"][key] for st in per_layer])
                            for key in per_layer[0][f"sub{j}"]}
                for j in range(len(pattern))
            })

    x = common.rms_norm(x, model.final_norm, arch.norm_eps)
    logits = x @ _head(model, arch, x.dtype)
    return logits, total_aux, all_states


# ----------------------------------------------------------------------------
# loss
# ----------------------------------------------------------------------------


def loss_fn(model: Model, batch, arch: ArchConfig, aux_weight: float = 0.01):
    """Mean next-token negative log-likelihood (float32 logits) plus
    ``aux_weight`` times the MoE load-balance loss; returns (loss, {"nll",
    "aux"})."""
    logits, aux, _ = forward(model, batch, arch)
    targets = batch["targets"]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, targets.long()[..., None]).squeeze(-1)
    nll = torch.mean(logz - tgt_logit)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}
