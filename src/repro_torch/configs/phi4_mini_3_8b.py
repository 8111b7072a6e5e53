"""phi4-mini-3.8b [arXiv:2412.08905; hf]: RoPE SwiGLU GQA, 200k vocab."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
