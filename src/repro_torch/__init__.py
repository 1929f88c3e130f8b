"""repro_torch — the BAK coordinate-descent solver in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

The port of ``repro`` (JAX + Pallas on a TPU), laid out the same way:
``core`` (the handle API and the plain torch solvers), ``kernels`` (CUDA
C++ kernels with their plain torch versions), ``store`` (host-memory
designs for non-resident handles), ``obs`` (metrics, spans, the dispatch
relay, profiler regions), ``resilience`` (fault injection, the retry
ladder), ``serve`` (the serving engine and its lanes) and ``launch``
(the serving CLI).  It imports neither JAX nor ``repro``.
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
