"""repro_torch.kernels — hand-written CUDA kernels for the solver hot path.

  fused_solve.py  whole-solve SolveBakP / SolveBak: one launch runs every
                  sweep, the SSE and the stopping rule on the card, with a
                  true early exit (csrc/fused_solve.cu, csrc/bak_fused.cu).
  cd_sweep.py     one SolveBakP sweep (csrc/bakp_sweep.cu), one SolveBak
                  sweep (csrc/bak_sweep.cu), the launch plans of the
                  cluster kernels (bakp_plan / bakp_grid for Algorithm 2,
                  bak_grid for Algorithm 1) and the on-chip budget; the
                  steps the kernels share are csrc/bakp_cluster.cuh
                  (bakp_sweep, and through csrc/bakp_solve.cuh's loop
                  fused_solve and stream_solve) and csrc/bak_column.cuh.
  stream_solve.py whole-solve SolveBakP with x left in device memory and
                  streamed through a shared-memory ring
                  (csrc/stream_solve.cu), and the out-of-core host-block
                  loop stream_solve_blocks.
  block_update.py the streamed-obs kernels: rank-CB residual correction
                  (csrc/block_update.cu) and SolveBakF feature scores
                  (csrc/score_features.cu).
  ops.py          solver entries: solvebakp_kernel (fused when the design
                  fits, per-sweep loop otherwise), solvebakp_stream_kernel
                  (streaming when a CTA's ring fits, per-sweep loop
                  otherwise), score_features_kernel, block_update_kernel.
  ref.py          plain-torch oracles.
  _build.py       nvcc build into kernels/build/, ctypes loading, launch
                  counts.

Every kernel has a plain torch version in its module; a wrapper runs it for
CPU tensors and launches the kernel for CUDA tensors.  Nothing is compiled
or loaded at import.  The x-reading kernels take x in fp32 or bf16 and
widen a bf16 x to fp32 as they load it.  The kernels use fp32 FMAs only;
the plain versions use ``torch.matmul``, which on the card stays in full
fp32 only with
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default,
which ``chip_smoke.py`` sets before comparing).
"""
from repro_torch.kernels._build import launch_counts, reset_launch_counts
from repro_torch.kernels.block_update import block_update, score_features
from repro_torch.kernels.cd_sweep import bakp_sweep, cd_sweep
from repro_torch.kernels.fused_solve import (fused_fits, fused_solve,
                                             fused_working_set_bytes)
from repro_torch.kernels.ops import (block_update_kernel,
                                     score_features_kernel, solvebakp_kernel,
                                     solvebakp_persweep_kernel,
                                     solvebakp_stream_kernel)
from repro_torch.kernels.stream_solve import (stream_fits, stream_solve,
                                              stream_solve_blocks,
                                              stream_x_resident_bytes)

__all__ = [
    "bakp_sweep",
    "block_update",
    "block_update_kernel",
    "cd_sweep",
    "fused_fits",
    "fused_solve",
    "fused_working_set_bytes",
    "launch_counts",
    "reset_launch_counts",
    "score_features",
    "score_features_kernel",
    "solvebakp_kernel",
    "solvebakp_persweep_kernel",
    "solvebakp_stream_kernel",
    "stream_fits",
    "stream_solve",
    "stream_solve_blocks",
    "stream_x_resident_bytes",
]
