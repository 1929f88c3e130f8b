"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone (audio
frontend stubbed; input_specs provides precomputed frame embeddings).

[arXiv:2308.11596; hf]  24 encoder + 24 decoder layers, d_model=1024 16H
(kv=16, MHA) d_ff=8192 vocab=256206.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    n_enc_layers=24,
    n_dec_layers=24,
    enc_input_dim=1024,
    src_len_for_decode=4096,
    microbatch=2,
    max_cache_len=32768,
)
