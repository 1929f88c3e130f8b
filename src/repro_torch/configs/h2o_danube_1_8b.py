"""h2o-danube-1.8b — llama/mistral-style dense with sliding-window attention.

[arXiv:2401.16818; hf]  24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, SWA window 4096 on every layer → ring KV cache of 4096 slots;
sub-quadratic, runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    layer_pattern="swa",
    sliding_window=4096,
    microbatch=2,
    max_cache_len=524288,
)
