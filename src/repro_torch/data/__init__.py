"""repro_torch.data — the synthetic token pipeline (numpy, no torch)."""
from repro_torch.data.pipeline import DataState, SyntheticLM

__all__ = ["DataState", "SyntheticLM"]
