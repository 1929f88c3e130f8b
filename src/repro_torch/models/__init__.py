"""repro_torch.models — the LM stack for every family: dense (qwen3-8b,
h2o-danube-1.8b's SWA ring, gemma2-9b's local/global pairs, minicpm3-4b's
MLA, an int8 KV cache for any GQA config), VLM (qwen2-vl-2b's M-RoPE),
MoE (dbrx-132b, arctic-480b's dense residual), SSM (mamba2-370m), hybrid
(zamba2-7b) and enc-dec (seamless-m4t-large-v2's encoder and
cross-attending decoder): parameter trees, attention, MoE and Mamba2
blocks, the caches, the training loss, prefill and decode.  The port of
the JAX package's ``models``."""
