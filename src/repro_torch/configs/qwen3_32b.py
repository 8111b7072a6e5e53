"""qwen3-32b [hf:Qwen/Qwen3; hf]: qk_norm, GQA kv=8, explicit head_dim."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,  # qwen3 projects to n_heads * 128 != d_model
    qk_norm=True,
    rope_theta=1_000_000.0,
)
