"""Mixture-of-Experts channel mixer (olmoe 64e/top-8, mixtral 8e/top-2).

Port of ``repro/models/moe.py``: the same function -- groups, capacity,
float32 router softmax, top-k with renormalised gates, token-major queue
positions with drops past capacity, a SwiGLU per expert, the gated combine
and the Switch aux loss -- with another dispatch.  The reference routes
through one-hot (G, Tg, E, C) einsums, its way of avoiding gathers on the
TPU.  The port puts each kept (token, choice) into its slot of its
expert's queue by index, runs the experts as products batched over
experts (``torch.bmm``), and gathers each token's k outputs back.

Ties: ``jax.lax.top_k`` puts the lower expert index first among equal
probabilities, and bf16 router logits tie often; ``torch.topk`` promises no
order among ties, so the port takes the top k of a stable descending sort.

Router-collapse telemetry: ``assignment_stream`` packs the (token, expert)
pairs into int32 words for a sketch board; distinct-pair cardinality far
below tokens * top_k indicates collapse.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models import common

GROUP_TOKENS = 4096  # tokens per routing group, at most
DROP_FREE_TOKENS = 256  # groups this small (decode, tests) route without drops


class MoE(common.Params):
    """The MoE channel mix's parameters (``init_params``'s names)."""


class Routing(NamedTuple):
    """Where each (token, choice) of a (G, Tg) grouping goes."""

    probs: torch.Tensor  # (G, Tg, E) float32 router softmax
    gates: torch.Tensor  # (G, Tg, k) float32, renormalised over the k choices
    expert_idx: torch.Tensor  # (G, Tg, k) int64, best first, lower index among ties
    slot: torch.Tensor  # (G, Tg, k) int64 position in the expert's queue
    keep: torch.Tensor  # (G, Tg, k) bool: slot < capacity


def param_shapes(arch: ArchConfig) -> Dict[str, tuple]:
    d, e, f = arch.d_model, arch.moe.num_experts, arch.moe.d_expert
    return {"router": (d, e), "gate": (e, d, f), "up": (e, d, f), "down": (e, f, d)}


def init_params(arch: ArchConfig, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The reference's distributions, drawn from ``generator`` on ``device``."""
    s = param_shapes(arch)
    d, f = arch.d_model, arch.moe.d_expert
    scale_in, scale_out = d ** -0.5, f ** -0.5
    return {
        "router": common.dense_init(generator, d, arch.moe.num_experts, device),
        "gate": common.normal(s["gate"], scale_in, generator, device),
        "up": common.normal(s["up"], scale_in, generator, device),
        "down": common.normal(s["down"], scale_out, generator, device),
    }


def group_tokens(seq: int) -> int:
    """Tokens per routing group of a (B, seq) batch: one group per sequence,
    split into groups of GROUP_TOKENS when longer."""
    return min(seq, GROUP_TOKENS)


def capacity(tg: int, moe: MoEConfig) -> int:
    """Slots per expert and group of ``tg`` tokens."""
    cap = int(moe.capacity_factor * tg * moe.top_k / moe.num_experts)
    if tg <= DROP_FREE_TOKENS:
        cap = tg * moe.top_k
    return max(cap, moe.top_k)


def route(params, xt: torch.Tensor, arch: ArchConfig, cap: int) -> Routing:
    """Router softmax, top-k and queue positions of grouped tokens xt (G, Tg, d)."""
    e, k = arch.moe.num_experts, arch.moe.top_k
    g, tg, _ = xt.shape
    logits = (xt @ params["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_idx = ranked[..., :k], order[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # a (token, choice)'s slot: the choices of its expert before it in
    # token-major, choice-minor order within the group.  The one-hot runs
    # (G, E, Tg * k), so the scan runs along the contiguous dim (along an
    # outer dim an H100 scanned one column a thread: 3.1 ms a layer of
    # olmoe-1b-7b's 8 x 1024-token prefill)
    flat = expert_idx.reshape(g, 1, tg * k)
    onehot = (flat == torch.arange(e, device=xt.device)[:, None]).int()
    before = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    slot = torch.gather(before, 1, flat).reshape(g, tg, k).long()
    return Routing(probs, gates, expert_idx, slot, slot < cap)


def moe_mixer(params, x: torch.Tensor, arch: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), aux_loss (), assignment (B, S, top_k) int32).

    Routing runs per group of ``group_tokens(S)`` tokens with
    ``capacity(tg)`` slots per expert; a (token, choice) past its expert's
    capacity is dropped and adds nothing to the token's output.
    """
    e, k = arch.moe.num_experts, arch.moe.top_k
    b, s, d = x.shape
    dt = x.dtype
    tg = group_tokens(s)
    n_groups = b * s // tg
    cap = capacity(tg, arch.moe)
    xt = x.reshape(n_groups, tg, d)
    r = route(params, xt, arch, cap)

    # dispatch: queue (expert, group) holds cap slots and one spare, where
    # the dropped choices land and whose outputs are never read
    slots = cap + 1
    group = torch.arange(n_groups, device=x.device)[:, None, None] * slots
    where = group + torch.where(r.keep, r.slot, cap)  # (G, Tg, k)
    xe = x.new_zeros((e, n_groups * slots, d))
    xe[r.expert_idx, where] = xt[:, :, None, :].expand(-1, -1, k, -1)

    # the experts' SwiGLU, batched over experts
    g = torch.bmm(xe, params["gate"].to(dt))
    u = torch.bmm(xe, params["up"].to(dt))
    act = F.silu(g.float()).to(dt) * u
    ye = torch.bmm(act, params["down"].to(dt))  # (E, G * slots, d)

    # combine: each token's k outputs weighted by their gates (rounded to the
    # activation dtype, as the reference's combine tensor), summed in float32
    weight = torch.where(r.keep, r.gates, 0.0).to(dt)
    picked = ye[r.expert_idx, where]  # (G, Tg, k, d)
    out = (weight.float()[..., None] * picked.float()).sum(dim=2).to(dt)

    # Switch-style load-balance aux loss
    frac_tokens = F.one_hot(r.expert_idx[..., 0], e).float().mean(dim=(0, 1))  # top-1
    frac_probs = r.probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out.reshape(b, s, d), aux, r.expert_idx.reshape(b, s, k).to(torch.int32)


def assignment_stream(token_ids: torch.Tensor, expert_idx: torch.Tensor) -> torch.Tensor:
    """(token, expert) pairs packed into int32 words for the HLL tap.

    token_ids (B, S), expert_idx (B, S, k) -> (B*S*k,) int32 where the low 8
    bits carry the expert and the rest the token id -- distinct-pair
    cardinality tracks router diversity.
    """
    t = token_ids[..., None].to(torch.int32)
    return torch.bitwise_or(torch.bitwise_left_shift(t, 8), expert_idx.to(torch.int32)).reshape(-1)
