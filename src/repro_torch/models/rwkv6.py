"""RWKV6 "Finch" token mixer: attention-free, data-dependent diagonal decay.

Port of ``repro/models/rwkv6.py``.  Structure follows arXiv:2404.05892:
token-shift ddlerp with LoRA deltas, per-channel data-dependent decay
w_t = exp(-exp(d_t)), bonus u for the current token, per-head state
S in R^{N x N}, grouped head norm, and the squared-ReLU channel mix.

Parameters live in two ``nn.Module``s, ``TimeMix`` and ``ChannelMix``,
under the reference's names; the functions below do the math on any
mapping of those names to tensors (a module indexes like a dict).  Every
weight is cast to the activation dtype where it is used, as the reference
does: no bf16 copy is kept, so the weights cost their float32 bytes alone,
and each call holds one transient bf16 copy of the weight it multiplies by.

``time_mix`` is the per-token recurrence; ``time_mix_chunked`` is the
chunked (GLA-style) form, whose intra-chunk term goes through the
``rwkv_intra`` kernel in one launch over every chunk and head of the layer,
and whose inter-chunk term and state update stay two ``einsum``s in a loop
over chunks, as the reference left them to XLA.  The kernel's gradient is
the ``rwkv_intra_bwd`` kernel, paired with it in ``IntraChunk``, a
``torch.autograd.Function``; the reference differentiates its inline chunk
math with ``jax.grad`` instead.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rwkv_intra import rwkv_intra, rwkv_intra_bwd
from repro_torch.models import common
from repro_torch.sharding import ctx as shardctx

LORA_RANK = 32
DECAY_RANK = 64
MIX_NAMES = ("w", "k", "v", "r", "g")  # ddlerp targets


class TimeMix(common.Params):
    """The time-mix sublayer's parameters (``init_params``'s names)."""


class ChannelMix(common.Params):
    """The channel-mix sublayer's parameters (``init_channel_params``'s names)."""


def param_shapes(arch: ArchConfig) -> Dict[str, tuple]:
    d = arch.d_model
    return {
        "mix_base": (5, d), "mix_lora_a": (5, d, LORA_RANK), "mix_lora_b": (5, LORA_RANK, d),
        "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d), "wo": (d, d),
        "decay_base": (d,), "decay_lora_a": (d, DECAY_RANK), "decay_lora_b": (DECAY_RANK, d),
        "u": (d,), "ln_w": (d,), "ln_b": (d,),
    }


def channel_param_shapes(arch: ArchConfig) -> Dict[str, tuple]:
    d, f = arch.d_model, arch.d_ff
    return {"mix_k": (d,), "mix_r": (d,), "wk": (d, f), "wr": (d, d), "wv": (f, d)}


def init_params(arch: ArchConfig, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The reference's distributions, drawn from ``generator`` on ``device``."""
    d = arch.d_model
    s = param_shapes(arch)

    def full(name, value):
        return torch.full(s[name], value, dtype=common.PARAM_DTYPE, device=device)

    def normal(name, scale):
        return common.normal(s[name], scale, generator, device)

    return {
        "mix_base": full("mix_base", 0.5),
        "mix_lora_a": normal("mix_lora_a", 0.01),
        "mix_lora_b": normal("mix_lora_b", 0.01),
        "wr": common.dense_init(generator, d, d, device),
        "wk": common.dense_init(generator, d, d, device),
        "wv": common.dense_init(generator, d, d, device),
        "wg": common.dense_init(generator, d, d, device),
        "wo": common.dense_init(generator, d, d, device),
        # decay: softplus-ish parameterization around slow decay
        "decay_base": full("decay_base", -0.5),
        "decay_lora_a": normal("decay_lora_a", 0.01),
        "decay_lora_b": normal("decay_lora_b", 0.01),
        "u": normal("u", 0.1),
        "ln_w": full("ln_w", 1.0),
        "ln_b": full("ln_b", 0.0),
    }


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token's activations, zeros before the first: (B, S, d)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ddlerp(params, x: torch.Tensor, x_prev: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Data-dependent token-shift interpolation -> dict of 5 mixed inputs."""
    sx = x_prev - x
    dt = x.dtype
    base = params["mix_base"].to(dt)  # (5, d)
    # shared LoRA trunk on the base-mixed input
    xxx = x + sx * base[0]
    out = {}
    for i, name in enumerate(MIX_NAMES):
        delta = torch.tanh(xxx @ params["mix_lora_a"][i].to(dt)) @ params["mix_lora_b"][i].to(dt)
        out[name] = x + sx * (base[i] + delta)
    return out


def _mixed_projections(params, mixed: Dict[str, torch.Tensor], dt: torch.dtype):
    """r, k, v, gate and log-decay of the mixed inputs, in their (..., d) shapes."""
    r = mixed["r"] @ params["wr"].to(dt)
    k = mixed["k"] @ params["wk"].to(dt)
    v = mixed["v"] @ params["wv"].to(dt)
    g = F.silu((mixed["g"] @ params["wg"].to(dt)).float())
    # data-dependent log-decay: lw = -exp(base + lora(x_w)) <= 0
    dd = params["decay_base"].float() + (
        torch.tanh(mixed["w"] @ params["decay_lora_a"].to(dt)) @ params["decay_lora_b"].to(dt)
    ).float()
    log_w = -torch.exp(torch.clamp(dd, -8.0, 8.0))
    return r, k, v, g.to(dt), log_w


def _projections(params, x: torch.Tensor, arch: ArchConfig):
    """Full-sequence r/k/v/decay projections (B, S, H, N) + gate (B, S, d)."""
    b, s, d = x.shape
    h, n = arch.n_heads, arch.rwkv_head_dim
    r, k, v, g, log_w = _mixed_projections(params, _ddlerp(params, x, _shift(x)), x.dtype)
    bshn = ("batch", None, "model", None)
    r = shardctx.constrain(r.reshape(b, s, h, n), bshn)
    k = shardctx.constrain(k.reshape(b, s, h, n), bshn)
    v = shardctx.constrain(v.reshape(b, s, h, n), bshn)
    log_w = shardctx.constrain(log_w.reshape(b, s, h, n), bshn)
    return r, k, v, g, log_w


def _head_norm(params, y: torch.Tensor, arch: ArchConfig, eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm with one group per head over (B, S, H, N)."""
    yf = y.float()
    mean = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, correction=0)  # jnp.var: population variance
    yn = (yf - mean) * torch.rsqrt(var + eps)
    b, s, h, n = y.shape
    yn = yn.reshape(b, s, h * n)
    return yn * params["ln_w"].float() + params["ln_b"].float()


def recurrence_step(state, r, k, v, log_w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the RWKV6 recurrence. Returns (new_state, out (B,H,N))."""
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = kf[..., :, None] * vf[..., None, :]  # (B, H, N, N)
    y = torch.einsum("bhn,bhnv->bhv", rf, state + u[..., None] * kv)
    new_state = torch.exp(log_w.float())[..., None] * state + kv
    return new_state, y


def _zero_state(b: int, arch: ArchConfig, device) -> torch.Tensor:
    n = arch.rwkv_head_dim
    return torch.zeros((b, arch.n_heads, n, n), dtype=torch.float32, device=device)


def _output(params, y: torch.Tensor, g: torch.Tensor, x: torch.Tensor, arch: ArchConfig) -> torch.Tensor:
    """Head norm, gate and output projection of y (B, S, H, N)."""
    y = _head_norm(params, y, arch).to(x.dtype) * g
    return y @ params["wo"].to(x.dtype)


def time_mix(params, x: torch.Tensor, arch: ArchConfig, state: torch.Tensor = None):
    """Full-sequence RWKV6 time mixing, one token at a time.

    Returns (out (B, S, d), final_state (B, H, N, N)).
    """
    b, s, d = x.shape
    h, n = arch.n_heads, arch.rwkv_head_dim
    r, k, v, g, log_w = _projections(params, x, arch)
    u = params["u"].float().reshape(h, n)
    if state is None:
        state = _zero_state(b, arch, x.device)
    state = shardctx.constrain(state, ("batch", "model", None, None))
    ys = []
    for t in range(s):
        state, y = recurrence_step(state, r[:, t], k[:, t], v[:, t], log_w[:, t], u)
        ys.append(y)
    y = torch.stack(ys, dim=1)  # (B, S, H, N)
    return _output(params, y, g, x, arch), state


class IntraChunk(torch.autograd.Function):
    """The intra-chunk term with its gradient: forward ``rwkv_intra``, backward
    ``rwkv_intra_bwd`` -- each the kernel on CUDA tensors and the plain
    version on CPU tensors, looked up in this module when called.  The bonus
    ``u`` enters expanded to one row per cell; autograd sums its per-cell
    gradient back over the expansion."""

    @staticmethod
    def forward(ctx, r, k, v, lex, lcum, u):
        ctx.save_for_backward(r, k, v, lex, lcum, u)
        return rwkv_intra(r, k, v, lex, lcum, u)

    @staticmethod
    def backward(ctx, dy):
        return rwkv_intra_bwd(*ctx.saved_tensors, dy.contiguous())


def _to_grid(t: torch.Tensor) -> torch.Tensor:
    """(B, NC, C, H, N) -> (B * NC * H, C, N), the kernel's cells."""
    b, nc, c, h, n = t.shape
    return t.permute(0, 1, 3, 2, 4).reshape(b * nc * h, c, n)


def time_mix_chunked(params, x: torch.Tensor, arch: ArchConfig, state: torch.Tensor = None,
                     chunk: int = 32):
    """Chunk-parallel RWKV6 (GLA-style); the same math as ``time_mix``.

      y_t   = (r_t * exp(Lex_t)) @ S_0                           [inter-chunk]
            + sum_{s<t} [sum_n r_t k_s exp(Lex_t - L_s)]_n v_s   [intra]
            + (r_t . (u * k_t)) v_t                              [bonus diag]
      S_C   = Diag(exp(L_C)) S_0 + sum_s (k_s * exp(L_C - L_s))^T v_s

    where L is the inclusive log-decay cumsum within the chunk and
    Lex = L - log_w the exclusive one.  Every exponent is a relative decay
    (<= 0).  The intra and diag terms do not depend on the carried state,
    so one ``rwkv_intra`` launch computes them for every chunk and head of
    the layer at once; the loop over chunks carries the state.  Chunks are
    c = min(chunk, S) tokens; a sequence that c does not divide takes the
    per-token ``time_mix``, as in the reference.
    """
    b, s, d = x.shape
    h, n = arch.n_heads, arch.rwkv_head_dim
    c = min(chunk, s)
    if s % c != 0:
        return time_mix(params, x, arch, state)
    nc = s // c
    r, k, v, g, log_w = _projections(params, x, arch)
    u = params["u"].float().reshape(h, n)
    if state is None:
        state = _zero_state(b, arch, x.device)
    state = shardctx.constrain(state, ("batch", "model", None, None))

    # (B, NC, C, H, N) f32 chunk views
    def chunked(t):
        return t.float().reshape(b, nc, c, h, n)

    rc, kc, vc, lwc = chunked(r), chunked(k), chunked(v), chunked(log_w)
    L = torch.cumsum(lwc, dim=2)  # inclusive log-decay
    Lex = L - lwc  # exclusive
    Lend = L[:, :, -1:]  # (B, NC, 1, H, N)

    ug = u[None, None].expand(b, nc, h, n).reshape(b * nc * h, n)
    y_intra = IntraChunk.apply(_to_grid(rc), _to_grid(kc), _to_grid(vc), _to_grid(Lex), _to_grid(L), ug)
    y_intra = y_intra.reshape(b, nc, h, c, n).permute(0, 1, 3, 2, 4)  # (B, NC, C, H, N)

    r_in = rc * torch.exp(Lex)  # weights against S_0
    k_out = kc * torch.exp(Lend - L)  # contribution weights into S_end
    wend = torch.exp(Lend)
    y_inter = []
    for i in range(nc):
        y_inter.append(torch.einsum("bthn,bhnv->bthv", r_in[:, i], state))
        kv = torch.einsum("bthn,bthv->bhnv", k_out[:, i], vc[:, i])
        state = wend[:, i, 0, :, :, None] * state + kv
    y = (torch.stack(y_inter, dim=1) + y_intra).reshape(b, s, h, n)
    return _output(params, y, g, x, arch), state


def _projections_step(params, x_t: torch.Tensor, x_prev: torch.Tensor, arch: ArchConfig):
    """Single-token variant of _projections using explicit shift state."""
    b, d = x_t.shape
    h, n = arch.n_heads, arch.rwkv_head_dim
    r, k, v, g, log_w = _mixed_projections(params, _ddlerp(params, x_t, x_prev), x_t.dtype)
    return r.reshape(b, h, n), k.reshape(b, h, n), v.reshape(b, h, n), g, log_w.reshape(b, h, n)


def time_mix_step(params, x_t: torch.Tensor, x_prev: torch.Tensor, state: torch.Tensor, arch: ArchConfig):
    """Single-token decode step.

    x_t: (B, d) current token activations; x_prev: (B, d) previous token
    (token-shift state); state: (B, H, N, N).
    Returns (out (B, d), new_state).
    """
    b, d = x_t.shape
    h, n = arch.n_heads, arch.rwkv_head_dim
    r, k, v, g, log_w = _projections_step(params, x_t, x_prev, arch)
    u = params["u"].float().reshape(h, n)
    state, y = recurrence_step(state, r, k, v, log_w, u)
    y = _head_norm(params, y.reshape(b, 1, h, n), arch)
    y = y.reshape(b, h * n).to(x_t.dtype) * g
    return y @ params["wo"].to(x_t.dtype), state


# ----------------------------------------------------------------------------
# channel mix (squared-ReLU)
# ----------------------------------------------------------------------------


def init_channel_params(arch: ArchConfig, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    d, f = arch.d_model, arch.d_ff
    half = torch.full((d,), 0.5, dtype=common.PARAM_DTYPE, device=device)
    return {
        "mix_k": half,
        "mix_r": half.clone(),
        "wk": common.dense_init(generator, d, f, device),
        "wr": common.dense_init(generator, d, d, device),
        "wv": common.dense_init(generator, f, d, device),
    }


def channel_mix(params, x: torch.Tensor, x_prev: torch.Tensor = None) -> torch.Tensor:
    """RWKV channel mixing: r = sigmoid, k = relu^2. Shapes (B, S, d)."""
    dt = x.dtype
    if x_prev is None:
        x_prev = _shift(x)
    xk = x + (x_prev - x) * params["mix_k"].to(dt)
    xr = x + (x_prev - x) * params["mix_r"].to(dt)
    k = torch.square(torch.relu(xk @ params["wk"].to(dt)))
    r = torch.sigmoid((xr @ params["wr"].to(dt)).float())
    return r.to(dt) * (k @ params["wv"].to(dt))
