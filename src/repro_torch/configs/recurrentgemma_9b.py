"""recurrentgemma-9b (Griffin) [arXiv:2402.19427]: RG-LRU + local attn 1:2."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,  # 12 x (rec, rec, attn) + 2 rec
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,  # MQA
    d_ff=12288,
    vocab_size=256000,
    tie_embeddings=True,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    rope_theta=10_000.0,
)
