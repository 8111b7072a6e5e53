"""Config registry: --arch <id> resolution for every assigned architecture.

A copy of ``repro/configs``: the configurations are pure data, kept here so
that the port imports nothing of the reference.  ``ArchConfig.param_count``
counts through the port's own ``models/registry.py``.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig, MoEConfig  # noqa: F401
from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES,
    ShapeConfig,
    is_cell_supported,
    skip_reason,
)

_ARCH_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "rwkv6-3b": "rwkv6_3b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "smollm-360m": "smollm_360m",
    "qwen3-32b": "qwen3_32b",
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def all_archs() -> Dict[str, ArchConfig]:
    return {a: get_arch(a) for a in ARCH_IDS}
