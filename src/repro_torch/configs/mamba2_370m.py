"""mamba2-370m — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=1024, ssm_state=128,
expand=2 → d_inner=2048, head_dim=64 → 32 SSM heads, vocab=50280.
Sub-quadratic: runs the long_500k cell (O(1) decode state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,            # = d_inner / ssm_head_dim (informational)
    n_kv_heads=32,
    head_dim=64,
    d_ff=0,                # attention-free, no MLP (Mamba2 block only)
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    microbatch=4,
    max_cache_len=524288,
)
