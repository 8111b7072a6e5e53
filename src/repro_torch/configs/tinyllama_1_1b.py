"""tinyllama-1.1b [arXiv:2401.02385; hf]: llama2-arch small, GQA kv=4."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10_000.0,
)
