"""repro_torch.optim — optimizers, the LR schedule and gradient clipping.

The port of the JAX package's ``repro.optim``: AdamW (fp32 master copies
and moments) and Adafactor (factored second moment, for the configs whose
AdamW state is too large), functional on trees of tensors with JAX's state
trees and names.  The updates write the state and the parameters in place
and return them.
"""
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.api import make_optimizer, opt_state_from_numpy
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "adafactor_init", "adafactor_update", "adamw_init", "adamw_update",
    "cosine_schedule", "make_optimizer", "opt_state_from_numpy",
]
