"""Continuous batching: per-slot decode positions + slot recycling.

Port of ``repro/serve/scheduler.py``.  ``engine.decode_step`` with one
position is batch-uniform -- fine for static batches, not for a serving
system where requests arrive and finish at different times.  This module
lifts it to per-slot state:

  * ``decode_step_slots``: every batch slot carries its own position and
    its own ring-buffer slot map, so a slot can be at token 7 while its
    neighbour is at token 31000.  The reference vmaps the single-sequence
    step; the port runs one batched step with (B,) positions and (B, W)
    position maps (``engine.decode_step``), which computes each row as the
    single-sequence step does.
  * ``ContinuousBatcher``: admits queued requests into free slots, steps
    the whole batch at once, retires finished slots, recycles them for the
    next queued request -- iteration-level scheduling over the same step.

Invariant (tested): a request decoded in a mixed batch yields the tokens
it gets decoded alone.  On the card, cuBLAS may pick other GEMMs for other
batch sizes, so there the logits agree within a tolerance, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.serve import engine


def slotted_cache(arch: ArchConfig, batch: int, kv_len: int, device=None):
    """Like ``engine.init_cache`` but with per-slot (B, W) position maps."""
    cache = engine.init_cache(arch, batch, kv_len, device)
    return {k: (v.expand(batch, -1).clone() if k.startswith("kv_pos_") else v) for k, v in cache.items()}


def decode_step_slots(model: transformer.Model, cache, tokens: torch.Tensor, pos: torch.Tensor,
                      arch: ArchConfig):
    """Per-slot decode: tokens (B,), pos (B,) -- independent positions.
    Returns (logits (B, V), new cache)."""
    return engine.decode_step(model, cache, tokens, pos.reshape(-1), arch)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Admit/step/retire loop over a fixed slot count.

    Prefill is per-request (single-sequence) on admission; decode advances
    every live slot each iteration.
    """

    def __init__(self, model: transformer.Model, arch: ArchConfig, n_slots: int, kv_len: int):
        self.model = model
        self.arch = arch
        self.n_slots = n_slots
        self.kv_len = kv_len
        self.device = model.embed.device
        self.cache = slotted_cache(arch, n_slots, kv_len, self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int32)
        self.next_token = np.zeros(n_slots, np.int32)
        self.queue: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    # ---- internals ----------------------------------------------------------

    def _write_slot(self, slot: int, cache_1, pos: int, token: int):
        """Slot ``slot`` takes a single-sequence cache whole: its rings,
        states and position maps, so nothing of the slot's last request
        stays behind."""
        for key, value in cache_1.items():
            if key.startswith("kv_pos_"):
                self.cache[key][slot] = value
        for stage, stage_1 in zip(self.cache["stages"], cache_1["stages"]):
            for sub, entries in stage.items():
                for name, dst in entries.items():
                    dst[:, slot] = stage_1[sub][name][:, 0]
        self.pos[slot] = pos
        self.next_token[slot] = token

    @torch.inference_mode()
    def admit(self):
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                tokens = torch.as_tensor(np.asarray(req.prompt, np.int32)[None], device=self.device)
                logits, cache_1 = engine.prefill(self.model, {"tokens": tokens}, self.arch, kv_len=self.kv_len)
                first = int(torch.argmax(logits[0, -1]))
                self._write_slot(slot, cache_1, pos=len(req.prompt), token=first)
                req.generated.append(first)
                self.slot_req[slot] = req

    @torch.inference_mode()
    def step(self):
        """One decode iteration across all live slots."""
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not live:
            return
        logits, self.cache = decode_step_slots(
            self.model, self.cache,
            torch.as_tensor(self.next_token, device=self.device),
            torch.as_tensor(self.pos, device=self.device), self.arch,
        )
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for slot in live:
            req = self.slot_req[slot]
            self.pos[slot] += 1
            self.next_token[slot] = nxt[slot]
            req.generated.append(int(nxt[slot]))
            if len(req.generated) >= req.max_new or self.pos[slot] >= self.kv_len - 1:
                req.done = True
                self.slot_req[slot] = None  # retire -> slot recycled

    def run(self, max_iters: int = 10_000) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        reqs = list(self.queue)
        for _ in range(max_iters):
            self.admit()
            if not any(self.slot_req) and not self.queue:
                break
            self.step()
        for r in reqs:
            out[r.uid] = r.generated
        return out
