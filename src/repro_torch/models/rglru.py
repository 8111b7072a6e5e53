"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of ``repro/models/rglru.py``.  Block: proj-in (x-branch + GeLU gate
branch) -> causal depthwise conv1d (width 4) -> RG-LRU diagonal gated
recurrence -> gated proj-out.

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is a
diagonal linear scan.  The reference computes it with
``jax.lax.associative_scan``; ``rglru_scan`` follows that function's
odd/even recursion, so the port combines the same float32 values in the
same tree, in O(log S) tensor operations and without a loop over the
sequence.  a_t = exp(c * r_t * log sigmoid(lambda)) with c = 8 keeps
log a_t <= 0.  ``jax.nn.gelu`` is the tanh approximation, so the port's
GeLU is ``approximate="tanh"``; the causal conv adds its shifted products
in the reference's order, in the activation dtype.

Decode keeps (conv window, h) as the recurrent cache: O(1) per token.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.sharding import ctx as shardctx
from repro_torch.sketch.hll import resolve_device

C_FACTOR = 8.0
LAM_RANGE = (2.0, 6.0)  # lambda spans sigmoid(lambda) ~ 0.88..0.998


class RGLRU(common.Params):
    """The recurrent block's parameters (``init_params``'s names)."""


class RGLRUState(NamedTuple):
    conv: torch.Tensor  # (B, conv_width-1, d) trailing inputs
    h: torch.Tensor  # (B, d) recurrent state (float32)


def param_shapes(arch: ArchConfig) -> Dict[str, tuple]:
    d = arch.d_model
    return {
        "w_x": (d, d), "w_gate": (d, d), "conv_w": (arch.conv_width, d), "conv_b": (d,),
        "w_a": (d, d), "w_i": (d, d), "lam": (d,), "w_out": (d, d),
    }


def lam_init(d: int, device) -> torch.Tensor:
    """``jnp.linspace(2.0, 6.0, d)`` as its source defines it, one float32
    rounding per operation: start * (1 - step) + stop * step with step =
    iota / (d - 1), then stop itself -- the same bits on every device.
    XLA compiles that definition with a reciprocal, a folded stop / (d - 1)
    and fused multiply-adds chosen shape by shape, so the reference's
    values differ from these by up to 2 float32 ulps (and from
    ``torch.linspace``'s by up to 1) at most widths."""
    start, stop = (torch.tensor(v, dtype=torch.float32, device=device) for v in LAM_RANGE)
    if d == 1:
        return start[None]
    step = torch.arange(d - 1, dtype=torch.float32, device=device) / common.scalar(d - 1, device)
    return torch.cat([start * (1 - step) + stop * step, stop[None]])


def init_params(arch: ArchConfig, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The reference's distributions, drawn from ``generator`` on ``device``."""
    d, w = arch.d_model, arch.conv_width
    return {
        "w_x": common.dense_init(generator, d, d, device),
        "w_gate": common.dense_init(generator, d, d, device),
        "conv_w": common.normal((w, d), 1.0 / w, generator, device),
        "conv_b": torch.zeros((d,), dtype=common.PARAM_DTYPE, device=device),
        # recurrence gates
        "w_a": common.dense_init(generator, d, d, device),
        "w_i": common.dense_init(generator, d, d, device),
        "lam": lam_init(d, device),
        "w_out": common.dense_init(generator, d, d, device),
    }


def _gates(params, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recurrence gates of the conv output xc (..., d): (a, b) in float32."""
    xf = xc.float()
    r = torch.sigmoid(xf @ params["w_a"].float())
    i = torch.sigmoid(xf @ params["w_i"].float())
    log_a = C_FACTOR * r * F.logsigmoid(params["lam"].float())
    a = torch.exp(log_a)
    # sqrt(1 - a^2) through expm1 for stability near a ~ 1
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, beta * i * xf


def _causal_conv(params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d over (B, S, d), width w, in x's dtype."""
    w = params["conv_w"].shape[0]
    conv_w = params["conv_w"].to(x.dtype)
    out = x * conv_w[w - 1]
    shifted = x
    for i in range(1, w):
        shifted = F.pad(shifted, (0, 0, 1, 0))[:, :-1]
        out = out + shifted * conv_w[w - 1 - i]
    return out + params["conv_b"].to(x.dtype)


def _combine(left, right):
    a_l, b_l = left
    a_r, b_r = right
    return a_r * a_l, a_r * b_l + b_r


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1; even has as many elements as
    odd, or one more."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1], *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.associative_scan``'s recursion over dim 1: scan the pairwise
    combined half, then combine each odd prefix with the next element."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even_a, even_b = _combine((odd_a[:, :-1], odd_b[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        even_a, even_b = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_b = torch.cat([b[:, :1], even_b], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t (h_{-1} = 0) by parallel prefix over dim 1."""
    return _scan(a, b)[1]


def block(params, x: torch.Tensor, arch: ArchConfig, *, return_state: bool = False):
    """Full-sequence recurrent block. x (B, S, d) -> (B, S, d).

    With ``return_state`` also returns the decode-resumable RGLRUState
    (trailing conv window + final hidden state).
    """
    dt = x.dtype
    bsd = ("batch", None, "model")
    gate = F.gelu(shardctx.constrain(x @ params["w_gate"].to(dt), bsd).float(), approximate="tanh")
    xb = shardctx.constrain(x @ params["w_x"].to(dt), bsd)
    xc = _causal_conv(params, xb)
    a, b = _gates(params, xc)
    a = shardctx.constrain(a, bsd)
    b = shardctx.constrain(b, bsd)
    h = rglru_scan(a, b)  # (B, S, d) float32
    out = (h * gate).to(dt) @ params["w_out"].to(dt)
    if not return_state:
        return out
    w = params["conv_w"].shape[0]
    return out, RGLRUState(conv=xb[:, -(w - 1):].to(common.ACT_DTYPE), h=h[:, -1])


def block_step(params, x_t: torch.Tensor, state: RGLRUState, arch: ArchConfig) -> Tuple[torch.Tensor, RGLRUState]:
    """Single-token decode step. x_t (B, d); returns (out, new_state)."""
    dt = x_t.dtype
    gate = F.gelu((x_t @ params["w_gate"].to(dt)).float(), approximate="tanh")
    xb = x_t @ params["w_x"].to(dt)
    # conv over (state.conv ++ xb)
    window = torch.cat([state.conv.to(dt), xb[:, None, :]], dim=1)  # (B, w, d)
    xc = torch.einsum("bwd,wd->bd", window, params["conv_w"].to(dt)) + params["conv_b"].to(dt)
    a, b = _gates(params, xc)
    h = a * state.h + b  # (B, d) float32
    out = (h * gate).to(dt) @ params["w_out"].to(dt)
    return out, RGLRUState(conv=window[:, 1:], h=h)


def init_state(batch: int, arch: ArchConfig, device=None) -> RGLRUState:
    """A zero state on ``device`` (None: the card, which must exist)."""
    device = resolve_device(device)
    return RGLRUState(
        conv=torch.zeros((batch, arch.conv_width - 1, arch.d_model), dtype=common.ACT_DTYPE, device=device),
        h=torch.zeros((batch, arch.d_model), dtype=torch.float32, device=device),
    )
