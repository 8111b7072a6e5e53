"""Deterministic synthetic token pipeline with an HLL tap on the datapath.

Port of ``repro/data/pipeline.py``.  Counter-based generation: batch
``step`` is a pure function of (seed, step, shape) via Murmur3 over flat
uint32 counters -- stateless, restartable from a checkpointed step index,
identical across hosts (each host slices its shard), and made on the
device that trains on it.

Distributions:
  * ``zipf``    -- log-uniform over the vocab: ``floor(exp(u * ln V))`` in
                   float32, as the reference computes it
  * ``uniform`` -- uniform over the vocab
  * ``unique``  -- globally unique ids (sketch stress)

``unique`` and ``uniform`` are integer arithmetic and bit-identical to the
reference.  ``zipf`` rounds a float32 ``exp`` down to a token, and another
implementation of ``exp`` (XLA's, ATen's on the CPU, the card's ``expf``)
may return the neighbouring float32: below 2^23 that moves a token by one
where ``exp(u * ln V)`` lies within an ulp or two of an integer; above
2^23, where every float32 is an integer, it moves the token by its
value's ulp (up to 128 below 2^31).  So a few tokens in 10^5 differ
between the packages and between devices at a vocab of 49,152, and a few
in 100 at 2^31 - 1 (ROADMAP C.3; the tests state the count).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.models.common import scalar
from repro_torch.sketch import murmur3
from repro_torch.sketch.hll import resolve_device
from repro_torch.sketch.u64 import MASK32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    distribution: str = "zipf"  # zipf | uniform | unique


def _counters(cfg: DataConfig, step, device: torch.device) -> torch.Tensor:
    """The step's n + 1 flat uint32 counters (in int64); the +1 continues
    the stream for the last target."""
    n = cfg.global_batch * cfg.seq_len
    base = (int(step) * n) & MASK32
    return (base + torch.arange(n + 1, dtype=torch.int64, device=device)) & MASK32


def _zipf_exponent(h: torch.Tensor, cfg: DataConfig) -> torch.Tensor:
    """float32 u * ln V of uint32 hashes h, u = h / 2^32.  ln V is rounded
    to float32 on the host, as the reference's compiler folds the constant:
    the card's ``logf`` missed it by an ulp (V = 49152), which moved ~0.1 %
    of the tokens."""
    u = h.to(torch.float32) / scalar(2.0 ** 32, h.device)
    return u * scalar(math.log(cfg.vocab_size), h.device)


def zipf_exponent(cfg: DataConfig, step, device=None) -> torch.Tensor:
    """The float32 exponent whose ``exp``, floored, is each zipf token of the
    step's stream (n + 1 values; the targets run one on)."""
    counters = _counters(cfg, step, resolve_device(device))
    return _zipf_exponent(murmur3.murmur3_32(counters, seed=cfg.seed), cfg)


def batch_at_step(cfg: DataConfig, step, device=None) -> Dict[str, torch.Tensor]:
    """The global batch of an arbitrary step index, on ``device`` (the card by
    default): int32 (global_batch, seq_len) ``tokens`` and their next-token
    ``targets``."""
    n = cfg.global_batch * cfg.seq_len
    counters = _counters(cfg, step, resolve_device(device))
    h = murmur3.murmur3_32(counters, seed=cfg.seed)  # uint32 values in int64

    if cfg.distribution == "unique":
        tokens_full = counters % cfg.vocab_size
    elif cfg.distribution == "uniform":
        tokens_full = h % cfg.vocab_size
    else:  # zipf-ish: log-uniform inverse CDF, in float32
        logv = _zipf_exponent(h, cfg)
        tokens_full = torch.clamp(torch.exp(logv).to(torch.int64), max=cfg.vocab_size - 1)

    tokens_full = tokens_full.to(torch.int32)
    tokens = tokens_full[:n].reshape(cfg.global_batch, cfg.seq_len)
    # next-token targets; the +1 counter continues the stream
    targets = tokens_full[1 : n + 1].reshape(cfg.global_batch, cfg.seq_len)
    return {"tokens": tokens, "targets": targets}


def host_shard(batch: Dict[str, torch.Tensor], host_id: int, n_hosts: int) -> Dict[str, torch.Tensor]:
    """Slice the per-host batch shard (disjoint across hosts by batch dim)."""
    def slc(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per : (host_id + 1) * per]

    return {key: slc(value) for key, value in batch.items()}


def stream_chunks(cfg: DataConfig, n_chunks: int, start_step: int = 0,
                  device=None) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    """Iterator of (step, batch) -- the streaming feed for sketch benchmarks."""
    device = resolve_device(device)
    for s in range(start_step, start_step + n_chunks):
        yield s, batch_at_step(cfg, s, device)
