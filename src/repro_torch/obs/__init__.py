"""repro_torch.obs — the dispatch relay (see ``trace.py``)."""
from repro_torch.obs.trace import (consume_dispatch, dispatch_counts,
                                   fallback_counts, record_dispatch,
                                   reset_counters)

__all__ = [
    "consume_dispatch",
    "dispatch_counts",
    "fallback_counts",
    "record_dispatch",
    "reset_counters",
]
