"""qwen2-vl-2b — VLM text backbone with M-RoPE (vision frontend stubbed;
input_specs provides M-RoPE position streams; patch embeddings enter as
regular embedded positions).

[arXiv:2409.12191; hf]  28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, head_dim=128, mrope sections (16, 24, 24).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    microbatch=2,
    max_cache_len=32768,
)
