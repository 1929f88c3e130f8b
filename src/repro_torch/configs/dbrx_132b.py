"""dbrx-132b — Databricks DBRX base: fine-grained MoE.

[hf:databricks/dbrx-base; unverified]  40L d_model=6144 48H (GQA kv=8)
d_ff=10752 vocab=100352, MoE 16 experts top-4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    experts_per_token=4,
    moe_d_ff=10752,
    microbatch=8,
    max_cache_len=32768,
)
