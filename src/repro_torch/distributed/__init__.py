"""repro_torch.distributed — the fault-tolerance substrate (the sharding
and compression modules of the JAX package's ``distributed`` are still to
port: ROADMAP.md queue 1 item 3)."""
