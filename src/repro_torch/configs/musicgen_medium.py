"""musicgen-medium [arXiv:2306.05284; hf]: decoder-only over EnCodec tokens.

Backbone only — the EnCodec frontend is a stub: input_specs() provides
precomputed frame embeddings alongside the codebook token ids.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    rope_theta=10_000.0,
    frontend_stub_len=64,  # precomputed conditioning frame embeddings
)
