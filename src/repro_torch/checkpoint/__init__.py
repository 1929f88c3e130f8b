"""repro_torch.checkpoint — atomic checkpoints in the JAX package's
on-disk format, with keep-k GC."""
from repro_torch.checkpoint.checkpoint import (latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
