"""Model registry: parameter counts and arch-level helpers.

Port of ``repro/models/registry.py``.  Counts come from the modules' own
shape tables (``transformer.param_shapes``), the same tables the
initialisers draw from, so nothing is allocated to count; every family
counts as the reference does.
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def param_count(arch: ArchConfig, active_only: bool = False) -> int:
    total = sum(math.prod(shape) for shape in _leaves(transformer.param_shapes(arch)))
    if active_only and arch.moe is not None:
        moe = arch.moe
        total -= 3 * arch.d_model * moe.d_expert * (moe.num_experts - moe.top_k) * arch.n_layers
    return total


def embedding_params(arch: ArchConfig) -> int:
    n = arch.vocab_size * arch.d_model
    return n if arch.tie_embeddings else 2 * n


def non_embedding_params(arch: ArchConfig, active_only: bool = False) -> int:
    return param_count(arch, active_only) - embedding_params(arch)


def model_flops_per_token(arch: ArchConfig, kind: str) -> float:
    """2 * N (prefill/decode) or 6 * N (train) per token, N without the
    input embedding (a gather, not a matmul); attention scores excluded."""
    n = param_count(arch, active_only=True) - arch.vocab_size * arch.d_model
    mult = 6.0 if kind == "train" else 2.0
    return mult * n
