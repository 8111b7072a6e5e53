"""qwen2-vl-72b [arXiv:2409.12191; hf]: M-RoPE, dynamic-resolution VLM.

Backbone only — the vision tower is a stub: input_specs() provides
precomputed patch embeddings merged into the token sequence, plus the
(temporal, h, w) position-id triple that M-RoPE consumes.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    mrope=True,
    rope_theta=1_000_000.0,
    frontend_stub_len=256,  # precomputed image patch embeddings
)
