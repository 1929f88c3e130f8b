"""repro_torch.core — the BAK solver family's handle API in PyTorch.

A frozen ``SolverSpec`` names the method and its knobs; ``prepare(x, spec)``
builds a ``PreparedDesign`` owning the reusable per-design state on the GPU;
``handle.solve(y, a0)`` runs cheap per-RHS solves.  ``solve`` and
``fit_linear_probe`` are one-shot shims.

Layout (mirrors ``repro.core``):
  spec.py       SolverSpec + the port's method registry (MethodEntry).
  prepare.py    prepare()/PreparedDesign, prepared_from_arrays.
  methods.py    bak / bakp / bakp_gram / bakp_fused / bak_fused /
                bakp_stream / lstsq / normal / bakf.
  solvebak.py   Algorithm 1, plain torch (cyclic or random order), and
                its batch across designs.
  solvebakp.py  Algorithm 2 + gram mode, plain torch, and its batch
                across designs.
  solvebakf.py  Algorithm 3 (greedy selection) + the stepwise baseline.
  precondition.py  column normalisation.
  types.py      SolveResult, SelectResult, norms, sweep_stop_flags.
  api.py        solve, fit_linear_probe.
"""
from repro_torch.core.api import fit_linear_probe, solve
from repro_torch.core.prepare import (PreparedDesign, design_fingerprint,
                                      prepare, prepared_from_arrays)
from repro_torch.core.precondition import (ColumnScaling, normalize_columns,
                                           unscale_coef)
from repro_torch.core.solvebak import (solvebak, solvebak_batched,
                                      solvebak_onesweep)
from repro_torch.core.solvebakf import solvebakf, stepwise_regression_baseline
from repro_torch.core.solvebakp import (block_gram_cholesky, solvebakp,
                                       solvebakp_batched)
from repro_torch.core.spec import (PRECISIONS, MethodEntry, SolverSpec,
                                   UnsupportedSpecError,
                                   ensure_precision_supported, method_names,
                                   methods_for_precision, register_method,
                                   solver_method, streaming_methods)
from repro_torch.core.types import SelectResult, SolveResult

__all__ = [
    "ColumnScaling",
    "MethodEntry",
    "PRECISIONS",
    "PreparedDesign",
    "SelectResult",
    "SolveResult",
    "SolverSpec",
    "UnsupportedSpecError",
    "block_gram_cholesky",
    "design_fingerprint",
    "ensure_precision_supported",
    "fit_linear_probe",
    "method_names",
    "methods_for_precision",
    "normalize_columns",
    "prepare",
    "prepared_from_arrays",
    "register_method",
    "solve",
    "solvebak",
    "solvebak_batched",
    "solvebak_onesweep",
    "solvebakf",
    "solvebakp",
    "solvebakp_batched",
    "solver_method",
    "stepwise_regression_baseline",
    "streaming_methods",
    "unscale_coef",
]
