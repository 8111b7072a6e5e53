"""The four assigned input-shape cells (LM transformer shapes).

``decode_*`` / ``long_*`` lower serve_step (one new token against a KV cache
of seq_len); ``train_*`` / ``prefill_*`` lower train_step / prefill.
``long_500k`` requires sub-quadratic attention — the runnable set per arch is
decided by ``is_cell_supported`` (skips recorded in DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def has_subquadratic_path(arch: ArchConfig) -> bool:
    """True if per-token decode cost is bounded independent of context length."""
    if arch.mixer == "rwkv6":
        return True  # O(1) recurrent state
    if arch.block_pattern is not None:
        # hybrid: every attention layer must be local/windowed
        return arch.local_window is not None
    return arch.sliding_window is not None  # SWA bounds the KV


def is_cell_supported(arch: ArchConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return has_subquadratic_path(arch)
    return True


def skip_reason(arch: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    if is_cell_supported(arch, shape):
        return None
    return (
        f"{arch.name} is pure full attention (no sub-quadratic path); "
        f"long_500k decode requires bounded per-token cost — see DESIGN.md §5"
    )
