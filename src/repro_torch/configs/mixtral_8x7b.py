"""mixtral-8x7b [arXiv:2401.04088; hf]: 8-expert top-2 MoE, GQA, SWA."""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,  # per-expert FFN hidden dim
    vocab_size=32000,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336, sharding="tp"),
    sliding_window=4096,
    rope_theta=1_000_000.0,
)
