"""Shared building blocks of the models: dtypes, initialisers, RMS norm.

Port of the parts of ``repro/models/common.py`` that the RWKV6 path uses.
Activations are bf16 with float32 norm statistics; parameters are float32
and are cast to the activation dtype where they are used.  RoPE, M-RoPE
and SwiGLU wait for the attention slice (ROADMAP A.12).

Initialisers draw from an explicit ``torch.Generator`` on the device the
parameters live on; they give other numbers than ``jax.random`` from the
same seed, so the tests carry the reference's weights across with
``repro_torch.interop`` instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

ACT_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


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
