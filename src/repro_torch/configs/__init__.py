"""repro_torch.configs — one module per architecture (see registry.py), the
port's copy of the JAX package's configs."""
