"""rwkv6-3b (Finch) [arXiv:2404.05892; hf]: attention-free, data-dep decay."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    mixer="rwkv6",
    rwkv_head_dim=64,
    # chunked (GLA-style) time-mix by default: 57x memory-term reduction over
    # the per-token recurrence at identical math — EXPERIMENTS.md §Perf A.
    # Set to 0 for the paper-faithful per-token scan baseline.
    rwkv_chunk_size=64,
)
