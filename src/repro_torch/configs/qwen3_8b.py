"""qwen3-8b — dense GQA with per-head qk RMSNorm.

[hf:Qwen/Qwen3-8B; hf]  36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, head_dim=128, qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    microbatch=4,
    max_cache_len=32768,
)
