"""repro_torch.models — the LM stack's serving path for the dense and VLM
families (qwen3-8b, h2o-danube-1.8b's SWA ring, gemma2-9b's local/global
pairs, minicpm3-4b's MLA, qwen2-vl-2b's M-RoPE, and an int8 KV cache for
any GQA config): parameter trees, attention, the KV caches, prefill and
decode.  The port of the JAX package's ``models``; MoE, SSM / hybrid and
enc-dec raise ``NotImplementedError`` (``transformer.check_supported``)."""
