"""GQA attention: the blocked online-softmax form in plain PyTorch.

Port of ``repro/models/attention.py``.  ``flash_attention`` walks the keys
in blocks of ``kv_block`` and carries the running (max, sum-exp,
accumulator) triple, so scores are never materialized at (S, S): the same
algorithm as the reference's ``lax.scan``, as a Python loop over blocks.
Causal masking computes every block and masks it; a sliding window masks
keys at or before ``q - window`` as well (``_block_mask``).

GQA: the keys and values of KV head ``j`` serve query heads
``j * G .. j * G + G - 1`` (G = H / Hkv), as ``jnp.repeat`` lays them out.
Products are float32 over the bf16 operands' values, as the reference's
``preferred_element_type=jnp.float32``; the probabilities are rounded to
the activation dtype before the value product, as there.

The math stays in the port's own code -- no ``scaled_dot_product_attention``
-- so that the window and ring semantics stay visible and testable on the
CPU.  No TPU kernel computes attention in the reference, so none is here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.sharding import ctx as shardctx

NEG_INF = -1e30


class Attention(common.Params):
    """The attention sublayer's parameters (``init_params``'s names)."""


def param_shapes(arch: ArchConfig) -> Dict[str, tuple]:
    d, hd = arch.d_model, arch.head_dim
    shapes = {
        "wq": (d, arch.n_heads * hd),
        "wk": (d, arch.n_kv_heads * hd),
        "wv": (d, arch.n_kv_heads * hd),
        "wo": (arch.n_heads * hd, d),
    }
    if arch.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return shapes


def init_params(arch: ArchConfig, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The reference's distributions, drawn from ``generator`` on ``device``."""
    d, hd = arch.d_model, arch.head_dim
    p = {
        "wq": common.dense_init(generator, d, arch.n_heads * hd, device),
        "wk": common.dense_init(generator, d, arch.n_kv_heads * hd, device),
        "wv": common.dense_init(generator, d, arch.n_kv_heads * hd, device),
        "wo": common.dense_init(generator, arch.n_heads * hd, d, device),
    }
    if arch.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=common.PARAM_DTYPE, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=common.PARAM_DTYPE, device=device)
    return p


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """(..., Sq, Sk) bool: True where q may attend k (causal [+ window])."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    q_pos: torch.Tensor,  # (B, Sq) int
    k_pos: torch.Tensor,  # (B, Sk) int
    *,
    window: Optional[int] = None,
    kv_block: int = 512,
) -> torch.Tensor:
    """Blocked causal(+windowed) attention; returns (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / np.sqrt(d)
    kv_block = min(kv_block, sk)
    if sk % kv_block != 0:
        raise ValueError(f"seq_len {sk} must divide kv_block {kv_block}")
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    bsh = ("batch", None, "model", None)
    q = shardctx.constrain(q, bsh)
    k = shardctx.constrain(k, bsh)
    v = shardctx.constrain(v, bsh)
    qf = q.float()
    m_run = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, sq, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    for start in range(0, sk, kv_block):
        kj = k[:, start : start + kv_block].float()
        vj = v[:, start : start + kv_block].float()
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kj) * scale  # (B, Sq, H, kvb)
        mask = _block_mask(q_pos, k_pos[:, start : start + kv_block], window)  # (B, Sq, kvb)
        s = torch.where(mask[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = torch.einsum("bqhk,bkhd->bqhd", p.to(q.dtype).float(), vj)
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.to(q.dtype)


def qkv_project(params, x: torch.Tensor, arch: ArchConfig):
    """x (B, S, d) -> q (B, S, H, D), k/v (B, S, Hkv, D) with optional qk-norm."""
    b, s, _ = x.shape
    hd, dt = arch.head_dim, x.dtype
    bsh = ("batch", None, "model", None)
    q = shardctx.constrain((x @ params["wq"].to(dt)).reshape(b, s, arch.n_heads, hd), bsh)
    k = shardctx.constrain((x @ params["wk"].to(dt)).reshape(b, s, arch.n_kv_heads, hd), bsh)
    v = shardctx.constrain((x @ params["wv"].to(dt)).reshape(b, s, arch.n_kv_heads, hd), bsh)
    if arch.qk_norm:
        q = common.head_rms_norm(q, params["q_norm"], arch.norm_eps)
        k = common.head_rms_norm(k, params["k_norm"], arch.norm_eps)
    return q, k, v


def apply_positions(q, k, positions, arch: ArchConfig):
    """RoPE or M-RoPE on q and k; positions (B, S) for RoPE, (3, B, S) for M-RoPE."""
    rope = common.apply_mrope if arch.mrope else common.apply_rope
    return rope(q, positions, arch.rope_theta), rope(k, positions, arch.rope_theta)


def attend(params, q, k, v, positions, arch: ArchConfig, *, window: Optional[int] = None,
           kv_block: int = 512) -> torch.Tensor:
    """The rotated q, k and v through ``flash_attention`` and ``wo``: (B, S, d)."""
    flat_pos = positions[0] if arch.mrope else positions  # the mask uses the temporal stream
    out = flash_attention(q, k, v, flat_pos, flat_pos, window=window, kv_block=kv_block)
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ params["wo"].to(q.dtype)


def self_attention(params, x: torch.Tensor, positions, arch: ArchConfig, *,
                   window: Optional[int] = None, kv_block: int = 512) -> torch.Tensor:
    """Full-sequence causal self-attention (the prefill path)."""
    q, k, v = qkv_project(params, x, arch)
    q, k = apply_positions(q, k, positions, arch)
    return attend(params, q, k, v, positions, arch, window=window, kv_block=kv_block)


def reference_attention(params, x, positions, arch: ArchConfig, *, window=None) -> torch.Tensor:
    """Naive O(S^2)-memory oracle that the tests hold ``flash_attention`` to."""
    q, k, v = qkv_project(params, x, arch)
    q, k = apply_positions(q, k, positions, arch)
    flat_pos = positions[0] if arch.mrope else positions
    b, s, h, d = q.shape
    hkv = arch.n_kv_heads
    qg = q.reshape(b, s, hkv, h // hkv, d).float()
    scores = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) / common.scalar(np.sqrt(d), x.device)
    mask = _block_mask(flat_pos, flat_pos, window)
    scores = torch.where(mask[:, :, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p.to(x.dtype).float(), v.float())
    out = out.reshape(b, s, h, d).to(x.dtype)
    return out.reshape(b, s, -1) @ params["wo"].to(x.dtype)
