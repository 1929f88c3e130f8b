"""minicpm3-4b — multi-head latent attention (MLA).

[hf:openbmb/MiniCPM3-4B; hf]  62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64 — the KV
cache stores only the 256+32-wide latent stream (decode uses absorbed
matmuls).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,         # MLA is effectively MHA over latent-expanded K/V
    head_dim=96,           # qk_nope + qk_rope
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    microbatch=4,
    max_cache_len=32768,
)
