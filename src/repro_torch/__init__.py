"""repro_torch — the BAK coordinate-descent solver in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

The port of ``repro`` (JAX + Pallas on a TPU), laid out the same way:
``core`` (the handle API and the plain torch solvers), ``kernels`` (CUDA
C++ kernels with their plain torch versions), ``store`` (host-memory
designs for non-resident handles), ``obs`` (metrics, spans, the dispatch
relay, profiler regions), ``resilience`` (fault injection, the retry
ladder), ``serve`` (the serving engine and its lanes), ``configs`` (the
architecture registry), ``models`` (the LM stack of every family:
parameters, attention, the caches, the train, prefill and decode
forwards), ``optim`` (AdamW, Adafactor, the schedule and clipping),
``data`` (the synthetic token stream), ``checkpoint`` (JAX's checkpoint
format), ``distributed`` (the checkpoint manager and straggler monitor)
and ``launch`` (the solver-serving, LM-serving and training CLIs, the
train / prefill / decode steps, the device mesh).  It imports neither JAX
nor ``repro``.
"""
from repro_torch.core import (PreparedDesign, SolveResult, SolverSpec,
                              UnsupportedSpecError, fit_linear_probe,
                              prepare, prepared_from_arrays, solve)

__all__ = [
    "PreparedDesign",
    "SolveResult",
    "SolverSpec",
    "UnsupportedSpecError",
    "fit_linear_probe",
    "prepare",
    "prepared_from_arrays",
    "solve",
]
