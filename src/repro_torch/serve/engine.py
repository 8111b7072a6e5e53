"""Serving engine: prefill + single-token decode.

Port of ``repro/serve/engine.py`` for every family.
The cache keeps the reference's layout: ``{"stages": [per stage
{"sub<j>": entries}], "kv_pos_<W>": ...}``, each entry stacked over the
stage's layers.  An ``attn`` sublayer keeps

  k, v       (L, B, W, Hkv, D) bf16       a ring of W = min(kv_len, window)
             (int8 with ``kv_quant``)     slots: position p lives in slot
                                          p % W, so a sliding window's ring
                                          holds exactly the positions it
                                          may attend to;
  k_scale, v_scale (L, B, W, Hkv, 1) bf16 the int8 cache's scales;

beside one slot -> position map ``kv_pos_<W>`` per ring width, (W,) int32,
-1 for an empty slot, shared by the layers.  A ``rec`` (RG-LRU) sublayer
keeps

  conv       (L, B, w - 1, d) bf16    the conv's trailing inputs;
  h          (L, B, d) float32        the recurrent state;

and an ``rwkv`` sublayer

  s          (L, B, H, N, N) float32  the per-head state matrix;
  x_prev     (L, B, d) bf16           the time mix's token-shift input;
  cm_x_prev  (L, B, d) bf16           the channel mix's token-shift input.

A MoE channel mix keeps nothing: decode routes each token as a group of
one (drop-free, capacity top_k), as the reference does.

``decode_step`` takes one position for the whole batch, as the
reference's, or one per row with (B, W) position maps: the continuous
batcher's slotted layout (``serve/scheduler.py``), where the reference
vmaps the single-sequence step instead.  Decode attention materializes
(B, H, W) scores -- tiny -- against the ring.

The functions are functional like the reference's: a decode step returns
a new cache and leaves the one it was given as it was.  Every entry point
runs under ``torch.inference_mode()`` on the model's device.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, common, moe, rglru, rwkv6, transformer
from repro_torch.serve.kvquant import dequantize_kv, quantize_kv
from repro_torch.sketch.hll import resolve_device

NEG_INF = attention.NEG_INF


def cache_width(arch: ArchConfig, kind: str, kv_len: int) -> int:
    window = transformer._sublayer_window(kind, arch)
    return min(kv_len, window) if window else kv_len


# ----------------------------------------------------------------------------
# cache init
# ----------------------------------------------------------------------------


def init_cache(arch: ArchConfig, batch: int, kv_len: int, device=None) -> Dict[str, Any]:
    """Zeroed decode cache for a maximum context of ``kv_len`` tokens."""
    device = resolve_device(device)
    hd, hkv = arch.head_dim, arch.n_kv_heads
    h, n, d = arch.n_heads, arch.rwkv_head_dim, arch.d_model

    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    stages, pos_maps = [], {}
    for pattern, repeats in transformer.layer_stages(arch):
        stage = {}
        for j, kind in enumerate(pattern):
            if kind == "attn":
                w = cache_width(arch, kind, kv_len)
                kv_dtype = torch.int8 if arch.kv_quant else common.ACT_DTYPE
                stage[f"sub{j}"] = {
                    "k": zeros(repeats, batch, w, hkv, hd, dtype=kv_dtype),
                    "v": zeros(repeats, batch, w, hkv, hd, dtype=kv_dtype),
                }
                if arch.kv_quant:
                    stage[f"sub{j}"].update(
                        k_scale=zeros(repeats, batch, w, hkv, 1, dtype=torch.bfloat16),
                        v_scale=zeros(repeats, batch, w, hkv, 1, dtype=torch.bfloat16),
                    )
                pos_maps[f"kv_pos_{w}"] = torch.full((w,), -1, dtype=torch.int32, device=device)
            elif kind == "rec":
                stage[f"sub{j}"] = {
                    "conv": zeros(repeats, batch, arch.conv_width - 1, d, dtype=common.ACT_DTYPE),
                    "h": zeros(repeats, batch, d, dtype=torch.float32),
                }
            else:  # rwkv
                stage[f"sub{j}"] = {
                    "s": zeros(repeats, batch, h, n, n, dtype=torch.float32),
                    "x_prev": zeros(repeats, batch, d, dtype=common.ACT_DTYPE),
                    "cm_x_prev": zeros(repeats, batch, d, dtype=common.ACT_DTYPE),
                }
        stages.append(stage)
    return {"stages": stages, **pos_maps}


# ----------------------------------------------------------------------------
# prefill
# ----------------------------------------------------------------------------


@torch.inference_mode()
def prefill(model: transformer.Model, batch, arch: ArchConfig, kv_len: int):
    """Run the full prompt, returning (logits (B,S,V), populated cache)."""
    logits, _, states = transformer.forward(model, batch, arch, collect_state=True)
    b, s = batch["tokens"].shape
    device = logits.device
    cache = init_cache(arch, b, kv_len, device)
    for si, (pattern, _) in enumerate(transformer.layer_stages(arch)):
        for j, kind in enumerate(pattern):
            st = states[si][f"sub{j}"]
            tgt = cache["stages"][si][f"sub{j}"]
            if kind == "attn":
                w = cache_width(arch, kind, kv_len)
                take = min(s, w)
                pos = torch.arange(s - take, s, dtype=torch.int32, device=device)
                slots = (pos % w).long()
                k_tail, v_tail = st["k"][:, :, s - take :], st["v"][:, :, s - take :]
                if arch.kv_quant:
                    kq, ks = quantize_kv(k_tail)
                    vq, vs = quantize_kv(v_tail)
                    tgt["k"][:, :, slots], tgt["k_scale"][:, :, slots] = kq, ks
                    tgt["v"][:, :, slots], tgt["v_scale"][:, :, slots] = vq, vs
                else:
                    tgt["k"][:, :, slots] = k_tail
                    tgt["v"][:, :, slots] = v_tail
                cache[f"kv_pos_{w}"][slots] = pos
            elif kind == "rec":
                tgt["conv"] = st["conv"]
                tgt["h"] = st["h"]
            else:
                tgt["s"] = st["s"]
                tgt["x_prev"] = st["x_prev"].to(common.ACT_DTYPE)
                tgt["cm_x_prev"] = st["cm_x_prev"].to(common.ACT_DTYPE)
    return logits, cache


# ----------------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------------


def _decode_attn(sub: transformer.Block, cache: Dict[str, torch.Tensor], kv_pos: torch.Tensor,
                 x: torch.Tensor, pos: torch.Tensor, arch: ArchConfig):
    """Single-token attention against the ring cache. x (B, d), pos (B,),
    kv_pos (B, W) -> ((B, d), the sublayer's new ring entries)."""
    b = x.shape[0]
    hd, hkv = arch.head_dim, arch.n_kv_heads
    g = arch.n_heads // hkv
    q, k, v = attention.qkv_project(sub.mixer, x[:, None, :], arch)
    posvec = pos[:, None]
    if arch.mrope:
        posvec = posvec.expand(3, b, 1)
    q, k = attention.apply_positions(q, k, posvec, arch)

    w = cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    slot = (pos % w).long()  # (B,)

    def written(name, value):
        out = cache[name].clone()
        out[rows, slot] = value[:, 0]
        return out

    if arch.kv_quant:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        new_entries = {"k": written("k", kq), "v": written("v", vq),
                       "k_scale": written("k_scale", ks), "v_scale": written("v_scale", vs)}
        ck = dequantize_kv(new_entries["k"], new_entries["k_scale"], x.dtype)
        cv = dequantize_kv(new_entries["v"], new_entries["v_scale"], x.dtype)
    else:
        new_entries = {"k": written("k", k), "v": written("v", v)}
        ck, cv = new_entries["k"], new_entries["v"]

    qg = q.reshape(b, hkv, g, hd).float()
    scores = torch.einsum("bhgd,bwhd->bhgw", qg, ck.float()) / common.scalar(np.sqrt(hd), x.device)
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    valid[rows, slot] = True  # the token just written
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgw,bwhd->bhgd", p.to(x.dtype).float(), cv.float()).to(x.dtype)
    out = out.reshape(b, arch.n_heads * hd) @ sub.mixer["wo"].to(x.dtype)
    return out, new_entries


def _decode_sublayer(kind: str, sub: transformer.Block, lcache: Dict[str, torch.Tensor],
                     kv_pos_map: Dict[int, torch.Tensor], x: torch.Tensor, pos: torch.Tensor,
                     arch: ArchConfig):
    """One sublayer of decode; x (B, d). Returns (x, new_lcache)."""
    h = common.rms_norm(x, sub.norm1, arch.norm_eps)
    new_cache = dict(lcache)
    if kind == "attn":
        mixed, kv_new = _decode_attn(sub, lcache, kv_pos_map[lcache["k"].shape[1]], h, pos, arch)
        new_cache.update(kv_new)
    elif kind == "rec":
        mixed, st_new = rglru.block_step(sub.mixer, h, rglru.RGLRUState(conv=lcache["conv"], h=lcache["h"]), arch)
        new_cache.update(conv=st_new.conv, h=st_new.h)
    else:  # rwkv
        mixed, s_new = rwkv6.time_mix_step(sub.mixer, h, lcache["x_prev"].to(h.dtype), lcache["s"], arch)
        new_cache.update(s=s_new, x_prev=h.to(common.ACT_DTYPE))
    x = x + mixed

    h2 = common.rms_norm(x, sub.norm2, arch.norm_eps)
    if arch.moe is not None:
        ch = moe.moe_mixer(sub.channel, h2[:, None, :], arch)[0][:, 0]
    elif kind == "rwkv":
        ch = rwkv6.channel_mix(sub.channel, h2[:, None, :], lcache["cm_x_prev"].to(h2.dtype)[:, None, :])[:, 0]
        new_cache.update(cm_x_prev=h2.to(common.ACT_DTYPE))
    else:
        ch = common.swiglu(sub.channel, h2)
    return x + ch, new_cache


@torch.inference_mode()
def decode_step(model: transformer.Model, cache, token: torch.Tensor, pos, arch: ArchConfig):
    """One decode step. token (B,) int; pos the batch's position (an int or
    a 0-dim tensor), or (B,) positions with (B, W) ``kv_pos_<W>`` maps.

    Returns (logits (B, V) float32, new cache).
    """
    x = model.embed[token.long()].to(common.ACT_DTYPE)
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    per_row = pos.ndim == 1
    pos = pos.expand(b) if not per_row else pos
    rows = torch.arange(b, device=x.device)

    # slot -> position maps advance once per step (shared by all layers)
    kv_pos_map, new_pos_maps = {}, {}
    for key, arr in cache.items():
        if key.startswith("kv_pos_"):
            w = int(key.split("_")[-1])
            kv_pos_map[w] = arr if per_row else arr.expand(b, w)
            new = arr.clone()
            if per_row:
                new[rows, (pos % w).long()] = pos
            else:
                new[(pos[:1] % w).long()] = pos[:1]  # a 1-D index: no host read of the slot
            new_pos_maps[key] = new

    layer = iter(model.layers)
    new_stages = []
    for si, (pattern, repeats) in enumerate(transformer.layer_stages(arch)):
        stage_cache = cache["stages"][si]
        per_layer = []
        for rep in range(repeats):
            new_lc = {}
            for j, kind in enumerate(pattern):
                lcache = {key: val[rep] for key, val in stage_cache[f"sub{j}"].items()}
                x, new_lc[f"sub{j}"] = _decode_sublayer(kind, next(layer), lcache, kv_pos_map, x, pos, arch)
            per_layer.append(new_lc)
        new_stages.append({
            f"sub{j}": {key: torch.stack([lc[f"sub{j}"][key] for lc in per_layer])
                        for key in stage_cache[f"sub{j}"]}
            for j in range(len(pattern))
        })
    x = common.rms_norm(x, model.final_norm, arch.norm_eps)
    logits = (x @ transformer._head(model, arch, x.dtype)).float()
    return logits, {"stages": new_stages, **new_pos_maps}


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
