"""Shared building blocks: dtypes, initialisers, norms, RoPE / M-RoPE, SwiGLU.

Port of ``repro/models/common.py``.  Activations are bf16 with float32 norm
statistics and rotary angles; parameters are float32 and are cast to the
activation dtype where they are used.  Sublayer parameters live in
``Params`` modules under the reference's names.

Initialisers draw from an explicit ``torch.Generator`` on the device the
parameters live on; they give other numbers than ``jax.random`` from the
same seed, so the tests carry the reference's weights across with
``repro_torch.interop`` instead.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sketch.hll import resolve_device

ACT_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


class Params(nn.Module):
    """Frozen float32 parameters under given names, indexable like a dict."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------


def normal(shape, scale: float, generator: torch.Generator, device) -> torch.Tensor:
    """float32 N(0, scale^2) draws of ``shape`` on ``device``."""
    out = torch.randn(shape, generator=generator, dtype=PARAM_DTYPE, device=device)
    return out.mul_(scale)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    return normal((in_dim, out_dim), float(scale), generator, device)


def embed_init(generator: torch.Generator, vocab: int, dim: int, device) -> torch.Tensor:
    return normal((vocab, dim), 0.02, generator, device)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


def head_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm (qwen3): RMS over head_dim of (..., heads, head_dim)."""
    return rms_norm(x, weight, eps)


# ----------------------------------------------------------------------------
# rotary embeddings
# ----------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for standard RoPE; (head_dim/2,) float32 on ``device``
    (the card by default)."""
    device = resolve_device(device)
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / scalar(head_dim, device)
    return 1.0 / torch.pow(scalar(theta, device), exponents)


def scalar(value: float, device) -> torch.Tensor:
    """A float32 0-dim tensor on ``device``.  Dividing by it rounds once, as
    JAX does; dividing by a Python number multiplies by its reciprocal in
    PyTorch (on the card at least), which rounds twice."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the last dim (the half-split pairing) by
    (..., S, D/2) angles; x is (..., S, H, D)."""
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (..., S, H, D) by per-position angles; positions (..., S)."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)  # (D/2,)
    return _rotate(x, positions[..., None].float() * inv)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections=(2, 1, 1)) -> torch.Tensor:
    """M-RoPE (qwen2-vl): rotary split into (temporal, h, w) sections.

    positions: (3, ..., S) int -- one position stream per section;
    ``sections`` are relative shares of the head_dim/2 frequency slots.
    """
    d = x.shape[-1]
    half = d // 2
    total = sum(sections)
    splits = [half * s // total for s in sections]
    splits[-1] = half - sum(splits[:-1])
    inv = rope_frequencies(d, theta, x.device)
    pieces, start = [], 0
    for sec_idx, width in enumerate(splits):
        pieces.append(positions[sec_idx][..., None].float() * inv[start : start + width])
        start += width
    return _rotate(x, torch.cat(pieces, dim=-1))


# ----------------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------------


class SwiGLU(Params):
    """The SwiGLU channel mix's parameters (``gate``, ``up``, ``down``)."""


def swiglu_shapes(d_model: int, d_ff: int) -> Dict[str, tuple]:
    return {"gate": (d_model, d_ff), "up": (d_model, d_ff), "down": (d_ff, d_model)}


def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int, device) -> Dict[str, torch.Tensor]:
    return {
        "gate": dense_init(generator, d_model, d_ff, device),
        "up": dense_init(generator, d_model, d_ff, device),
        "down": dense_init(generator, d_ff, d_model, device),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ params["gate"].to(dt)
    u = x @ params["up"].to(dt)
    return (F.silu(g.float()).to(dt) * u) @ params["down"].to(dt)
