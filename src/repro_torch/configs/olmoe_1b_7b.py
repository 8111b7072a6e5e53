"""olmoe-1b-7b [arXiv:2409.02060; hf]: 64-expert top-8 MoE, MHA."""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,  # per-expert FFN hidden dim
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024, sharding="ep"),
    rope_theta=10_000.0,
)
