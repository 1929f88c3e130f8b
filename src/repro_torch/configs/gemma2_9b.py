"""gemma2-9b — alternating local(4096-window)/global attention, logit
softcaps, pre+post RMSNorm.

[arXiv:2408.00118; hf]  42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, head_dim=256; attn softcap 50.0, final softcap 30.0.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_pattern="alt_local_global",
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    tie_embeddings=True,
    microbatch=4,
    max_cache_len=32768,
)
