"""Int8 KV-cache quantization (per-token, per-head symmetric scales).

Port of ``repro/serve/kvquant.py``.  Quantizing K/V to int8 with a bf16
scale per (token, head) halves the cache and its read traffic at decode.
Layout: values int8 (..., W, Hkv, D), scales bf16 (..., W, Hkv, 1).

The int8 values and the bf16 scales are bit-identical to the reference's:
every division rounds once (``common.scalar``), and ``torch.round`` rounds
half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.common import scalar


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) bf16/float32 -> (int8 values, bf16 scale over the last dim)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / scalar(127.0, x.device) + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)
