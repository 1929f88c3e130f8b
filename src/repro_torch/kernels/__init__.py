"""repro_torch.kernels — hand-written CUDA kernels for the solver hot path.

  fused_solve.py  whole-solve SolveBakP: one cooperative launch runs every
                  sweep, the SSE and the stopping rule on the card, with a
                  true early exit (csrc/fused_solve.cu).
  cd_sweep.py     one SolveBakP sweep (csrc/bakp_sweep.cu) and the on-chip
                  budget; the block step both kernels share is
                  csrc/bakp_block.cuh.
  ops.py          solver entries: solvebakp_kernel (fused when the design
                  fits, per-sweep loop otherwise).
  ref.py          plain-torch oracles.
  _build.py       nvcc build into kernels/build/, ctypes loading, launch
                  counts.

Every kernel has a plain torch version in its module; a wrapper runs it for
CPU tensors and launches the kernel for CUDA tensors.  Nothing is compiled
or loaded at import.  The kernels use fp32 FMAs only; the plain versions
use ``torch.matmul``, which on the card stays in full fp32 only with
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default,
which ``chip_smoke.py`` sets before comparing).
"""
from repro_torch.kernels._build import launch_counts, reset_launch_counts
from repro_torch.kernels.cd_sweep import bakp_sweep
from repro_torch.kernels.fused_solve import (fused_fits, fused_solve,
                                             fused_working_set_bytes)
from repro_torch.kernels.ops import (solvebakp_kernel,
                                     solvebakp_persweep_kernel)

__all__ = [
    "bakp_sweep",
    "fused_fits",
    "fused_solve",
    "fused_working_set_bytes",
    "launch_counts",
    "reset_launch_counts",
    "solvebakp_kernel",
    "solvebakp_persweep_kernel",
]
