"""zamba2-7b — hybrid: Mamba2 backbone + shared attention block with
per-invocation LoRA deltas.

[arXiv:2411.15242; unverified]  81 layers = 13 units × (5 mamba2 + 1 shared
attn invocation) + 3 trailing mamba2; d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64.  The shared block's QKV weights are one set,
specialised per invocation by rank-128 LoRA (stacked over units).
Sub-quadratic backbone: runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    hybrid_units=13,
    mamba_per_unit=5,
    trailing_mamba=3,
    shared_lora_rank=128,
    microbatch=4,
    max_cache_len=524288,
)
