"""Serving engine: prefill + single-token decode.

Port of ``repro/serve/engine.py`` for the RWKV6 family.  The cache keeps
the reference's layout: ``{"stages": [per stage {"sub<j>": entries}]}``,
each entry stacked over the stage's layers.  An ``rwkv`` sublayer keeps

  s          (L, B, H, N, N) float32  the per-head state matrix;
  x_prev     (L, B, d) bf16           the time mix's token-shift input;
  cm_x_prev  (L, B, d) bf16           the channel mix's token-shift input.

The functions are functional like the reference's: a decode step returns a
new cache and leaves the one it was given as it was (the RWKV6-3B cache is
168 MB of state at B = 8, copied once a step).  Attention ring caches,
``kvquant`` and the recurrent (RG-LRU) sublayers come with ROADMAP A.12's
next slices.  Every entry point runs under ``torch.inference_mode()`` on
the model's device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, rwkv6, transformer
from repro_torch.sketch.hll import resolve_device


# ----------------------------------------------------------------------------
# cache init
# ----------------------------------------------------------------------------


def init_cache(arch: ArchConfig, batch: int, kv_len: int, device=None) -> Dict[str, Any]:
    """Zeroed decode cache for a maximum context of ``kv_len`` tokens."""
    transformer._check_supported(arch)
    device = resolve_device(device)
    h, n, d = arch.n_heads, arch.rwkv_head_dim, arch.d_model
    stages = []
    for pattern, repeats in transformer.layer_stages(arch):
        stages.append({
            f"sub{j}": {
                "s": torch.zeros((repeats, batch, h, n, n), dtype=torch.float32, device=device),
                "x_prev": torch.zeros((repeats, batch, d), dtype=common.ACT_DTYPE, device=device),
                "cm_x_prev": torch.zeros((repeats, batch, d), dtype=common.ACT_DTYPE, device=device),
            }
            for j, _ in enumerate(pattern)
        })
    return {"stages": stages}


# ----------------------------------------------------------------------------
# prefill
# ----------------------------------------------------------------------------


@torch.inference_mode()
def prefill(model: transformer.Model, batch, arch: ArchConfig, kv_len: int):
    """Run the full prompt, returning (logits (B,S,V), populated cache)."""
    logits, _, states = transformer.forward(model, batch, arch, collect_state=True)
    b, s = batch["tokens"].shape
    cache = init_cache(arch, b, kv_len, logits.device)
    for si, (pattern, _) in enumerate(transformer.layer_stages(arch)):
        for j, _ in enumerate(pattern):
            st = states[si][f"sub{j}"]
            tgt = cache["stages"][si][f"sub{j}"]
            tgt["s"] = st["s"]
            tgt["x_prev"] = st["x_prev"].to(common.ACT_DTYPE)
            tgt["cm_x_prev"] = st["cm_x_prev"].to(common.ACT_DTYPE)
    return logits, cache


# ----------------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------------


def _decode_sublayer(kind: str, sub: transformer.Block, lcache: Dict[str, torch.Tensor], x: torch.Tensor,
                     pos, arch: ArchConfig):
    """One sublayer of decode; x (B, d). Returns (x, new_lcache)."""
    if kind != "rwkv":
        raise transformer._unported(f"decoding the {kind!r} sublayer")
    h = common.rms_norm(x, sub.norm1, arch.norm_eps)
    new_cache = dict(lcache)
    mixed, s_new = rwkv6.time_mix_step(sub.mixer, h, lcache["x_prev"].to(h.dtype), lcache["s"], arch)
    new_cache.update(s=s_new, x_prev=h.to(common.ACT_DTYPE))
    x = x + mixed

    h2 = common.rms_norm(x, sub.norm2, arch.norm_eps)
    ch = rwkv6.channel_mix(sub.channel, h2[:, None, :], lcache["cm_x_prev"].to(h2.dtype)[:, None, :])[:, 0]
    new_cache.update(cm_x_prev=h2.to(common.ACT_DTYPE))
    return x + ch, new_cache


@torch.inference_mode()
def decode_step(model: transformer.Model, cache, token: torch.Tensor, pos, arch: ArchConfig):
    """One decode step. token (B,) int, pos the (batch-uniform) position.

    Returns (logits (B, V) float32, new cache).
    """
    x = model.embed[token.long()].to(common.ACT_DTYPE)
    layer = iter(model.layers)
    new_stages = []
    for si, (pattern, repeats) in enumerate(transformer.layer_stages(arch)):
        stage_cache = cache["stages"][si]
        per_layer = []
        for rep in range(repeats):
            new_lc = {}
            for j, kind in enumerate(pattern):
                lcache = {key: val[rep] for key, val in stage_cache[f"sub{j}"].items()}
                x, new_lc[f"sub{j}"] = _decode_sublayer(kind, next(layer), lcache, x, pos, arch)
            per_layer.append(new_lc)
        new_stages.append({
            f"sub{j}": {key: torch.stack([lc[f"sub{j}"][key] for lc in per_layer])
                        for key in stage_cache[f"sub{j}"]}
            for j in range(len(pattern))
        })
    x = common.rms_norm(x, model.final_norm, arch.norm_eps)
    logits = (x @ transformer._head(model, arch, x.dtype)).float()
    return logits, {"stages": new_stages}


@torch.inference_mode()
def decode_loop(model: transformer.Model, cache, first_token: torch.Tensor, start_pos, arch: ArchConfig,
                steps: int):
    """Greedy multi-step decode. Returns (tokens (B, steps) int32, cache)."""
    tok, pos, out = first_token, int(start_pos), []
    for _ in range(steps):
        logits, cache = decode_step(model, cache, tok, pos, arch)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        pos += 1
    if not out:
        return torch.zeros((first_token.shape[0], 0), dtype=torch.int32, device=first_token.device), cache
    return torch.stack(out, dim=1), cache
