"""smollm-360m [hf:HuggingFaceTB/SmolLM; hf]: llama-arch small, GQA kv=5."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
