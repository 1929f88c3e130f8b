"""repro_torch.models — the LM stack's serving path for the dense GQA
family (qwen3-8b): parameter trees, attention, the KV cache, prefill and
decode.  The port of the JAX package's ``models``; the other families
raise ``NotImplementedError`` (``transformer.check_supported``)."""
