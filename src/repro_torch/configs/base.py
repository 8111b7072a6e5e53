"""Architecture config schema for the 10 assigned archs (+ the paper's own).

Every field mirrors the published configuration; ``reduced()`` returns the
same-family smoke-test twin (small widths/layers/vocab) used by CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    # 'ep': shard experts over the model axis; 'tp': shard expert hidden dim
    sharding: str = "ep"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # token mixer: 'attention' | 'rwkv6' | pattern-based hybrid
    mixer: str = "attention"
    # repeating layer pattern for hybrids, e.g. ('rec', 'rec', 'attn');
    # None means all layers identical.
    block_pattern: Optional[Tuple[str, ...]] = None
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # SWA for all attention layers
    local_window: Optional[int] = None  # hybrid local-attention window
    mrope: bool = False  # qwen2-vl 3-section rotary
    rwkv_head_dim: int = 64
    # 0 = per-token scan (paper-faithful recurrence); >0 = GLA-style chunked
    # formulation with this chunk length (see EXPERIMENTS.md §Perf)
    rwkv_chunk_size: int = 0
    conv_width: int = 4  # RG-LRU temporal conv
    tie_embeddings: bool = False
    # int8 KV cache (per-token/head scales) — halves decode-cache memory and
    # read traffic; see serve/kvquant.py and EXPERIMENTS.md §Perf.
    kv_quant: bool = False
    norm_eps: float = 1e-6
    # modality frontend stub: number of precomputed embedding positions the
    # input carries (0 = pure token stream)
    frontend_stub_len: int = 0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.block_pattern is not None and self.n_layers < len(self.block_pattern):
            raise ValueError("n_layers smaller than one block pattern")

    # ----- derived quantities used by roofline / tests -----------------------

    @property
    def attention_params_per_layer(self) -> int:
        q = self.d_model * self.n_heads * self.head_dim
        kv = 2 * self.d_model * self.n_kv_heads * self.head_dim
        o = self.n_heads * self.head_dim * self.d_model
        return q + kv + o

    @property
    def mlp_params_per_layer(self) -> int:
        if self.moe is not None:
            per_expert = 3 * self.d_model * self.moe.d_expert
            router = self.d_model * self.moe.num_experts
            return per_expert * self.moe.num_experts + router
        return 3 * self.d_model * self.d_ff  # SwiGLU: gate, up, down

    def param_count(self) -> int:
        """Total parameters (exact for the layer stack + embeddings)."""
        from repro_torch.models import registry  # local import to avoid cycle

        return registry.param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        from repro_torch.models import registry

        return registry.param_count(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """Smoke-test twin: same family/features, tiny dims."""
        moe = None
        if self.moe is not None:
            moe = MoEConfig(
                num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_expert=64,
                capacity_factor=2.0,
                sharding=self.moe.sharding,
            )
        n_kv = min(self.n_kv_heads, 2)
        heads = max(4, n_kv)
        pattern = self.block_pattern
        n_layers = len(pattern) + 1 if pattern else 2
        return dataclasses.replace(
            self,
            rwkv_head_dim=128 // heads,  # keep n_heads * rwkv_head_dim == d_model
            n_layers=n_layers,
            d_model=128,
            n_heads=heads,
            n_kv_heads=n_kv,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            moe=moe,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            local_window=min(self.local_window, 64) if self.local_window else None,
            frontend_stub_len=min(self.frontend_stub_len, 16),
        )
