"""SolverSpec + the solver-method registry of the PyTorch port.

Counterpart of ``repro.core.spec``, with a registry of the port's own: the
two packages never share registrations.  ``SolverSpec`` keeps every field
of the JAX spec, so a spec means the same solve in both packages and its
``canonical()`` form hashes and compares the same way.

Shared semantics:
  * ``atol``/``rtol`` — iterative stopping tolerances; direct methods
    ("lstsq"/"normal") ignore them.
  * ``a0`` warm starts are a solve-time argument; direct methods ignore it.
  * ``ridge`` — Tikhonov diagonal for "normal" and the ``mode="gram"``
    block factorisations.
  * ``order="random"`` takes a ``torch.Generator`` at solve time
    (``generator=``), where the JAX package takes a PRNG ``key``.
  * fields a method does not consume (``MethodEntry.consumes``) are reset to
    defaults by ``canonical()``.
  * ``precision`` — names the storage precision of the X stream: "fp32",
    "bf16" (the kernels read a bf16 copy of x and keep every accumulator
    in fp32) or "bf16_fp32acc" (bf16, then up to ``refine_sweeps`` fp32
    polish sweeps).  A method's ``precisions`` lists the ones it runs, and
    ``ensure_precision_supported`` raises ``UnsupportedSpecError`` for any
    other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

# Spec fields every iterative BAK-family method consumes.
_ITER_FIELDS = ("max_iter", "atol", "rtol")

# Recognised SolverSpec.precision values (as in the JAX package).
PRECISIONS = ("fp32", "bf16", "bf16_fp32acc")

# Default fp32 polish budget for precision="bf16_fp32acc".
_REFINE_DEFAULT = 4


class UnsupportedSpecError(ValueError):
    """A structurally valid ``SolverSpec`` names a capability its method
    does not implement here (a bf16 precision, a sharded placement)."""


@dataclass(frozen=True)
class SolverSpec:
    """Frozen, hashable solver configuration (fields as the JAX spec).

    Attributes:
      method:   registry name of the solver method.
      max_iter: sweep budget for iterative methods.
      atol:     absolute RMSE tolerance (0 disables).
      rtol:     relative per-sweep improvement tolerance (0 disables).
      thr:      block width for the SolveBakP family (paper thread count).
      omega:    block-update relaxation factor (1.0 = paper-faithful).
      order:    column order for Algorithm 1: "cyclic" or "random".
      ridge:    Tikhonov diagonal for "normal" and ``mode="gram"``.
      precision: storage precision of the X stream.
      refine_sweeps: fp32 polish budget for "bf16_fp32acc".
    """

    method: str = "bakp_gram"
    max_iter: int = 50
    atol: float = 0.0
    rtol: float = 0.0
    thr: int = 128
    omega: float = 1.0
    order: str = "cyclic"
    ridge: float = 1e-6
    precision: str = "fp32"
    refine_sweeps: int = _REFINE_DEFAULT

    def __post_init__(self):
        # Type-normalise so rtol=0 and rtol=0.0 hash identically.
        object.__setattr__(self, "max_iter", int(self.max_iter))
        object.__setattr__(self, "thr", int(self.thr))
        object.__setattr__(self, "refine_sweeps", int(self.refine_sweeps))
        for f in ("atol", "rtol", "omega", "ridge"):
            object.__setattr__(self, f, float(getattr(self, f)))
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, "
                f"got {self.precision!r}")
        if _REGISTRY and self.method not in _REGISTRY:
            raise ValueError(
                f"method must be one of {method_names()}, got {self.method!r}")

    def replace(self, **changes) -> "SolverSpec":
        """A copy with ``changes`` applied (dataclasses.replace)."""
        return dataclasses.replace(self, **changes)

    def canonical(self) -> "SolverSpec":
        """The spec with every field its method ignores reset to defaults;
        ``refine_sweeps`` is also reset outside ``"bf16_fp32acc"``."""
        entry = solver_method(self.method)
        changes = {
            f.name: f.default
            for f in dataclasses.fields(self)
            if f.name != "method" and f.name not in entry.consumes
        }
        c = self.replace(**changes) if changes else self
        if (c.precision != "bf16_fp32acc"
                and c.refine_sweeps != _REFINE_DEFAULT):
            c = c.replace(refine_sweeps=_REFINE_DEFAULT)
        return c


@dataclass(frozen=True)
class MethodEntry:
    """One registered solver method.

    Attributes:
      name:      registry key (``SolverSpec.method``).
      solve:     ``(prepared, y, spec, *, a0, generator) -> SolveResult``
                 (plus ``placement``, ``mesh`` where ``shardable``).
      consumes:  SolverSpec fields that change this method's result.
      iterative: consumes ``max_iter``/``atol``/``rtol`` and honours ``a0``.
      multi_rhs: accepts ``y`` of shape (obs, k).
      batchable: batchable across designs (``vmap_one`` builds the batch
                 solver the serving engine stacks same-bucket designs into).
      shardable: has mesh-sharded backends (``core.distributed``; serving
                 placement eligibility): ``solve`` takes ``placement=`` and
                 ``mesh=`` keywords.
      blocked:   consumes ``thr`` (SolveBakP family).
      needs_chol: wants block-Gram Cholesky factors (``chol_for``).
      streams:   can solve a non-resident handle (x in host memory,
                 fetched block by block through ``PreparedDesign.blocks``).
      precisions: ``SolverSpec.precision`` values this method runs.
      lane:      single-device execution-lane kind ("xla" for the plain
                 torch family, "fused" for the whole-solve CUDA kernel,
                 "stream" for the streaming one).
      prepare:   optional ``(prepared, spec) -> None`` warming the
                 per-design state this method reuses.
      vmap_one:  optional ``spec -> batch`` where ``batch(xs, ys, cns,
                 atols, *, chols=None, a0s=None)`` solves B stacked
                 single-RHS systems (the port's counterpart of the JAX
                 registry's per-system callable under ``jax.vmap``).
      fallback:  the method a failed solve degrades to (the retry ladder,
                 ``repro_torch.resilience.ladder``, walks these).
      summary:   one-line description.
    """

    name: str
    solve: Callable
    consumes: Tuple[str, ...]
    iterative: bool = True
    multi_rhs: bool = True
    batchable: bool = False
    shardable: bool = False
    blocked: bool = False
    needs_chol: bool = False
    streams: bool = False
    precisions: Tuple[str, ...] = ("fp32",)
    lane: str = "xla"
    prepare: Optional[Callable] = None
    vmap_one: Optional[Callable] = None
    fallback: Optional[str] = None
    summary: str = ""


_REGISTRY: Dict[str, MethodEntry] = {}


def register_method(entry: MethodEntry, *, overwrite: bool = False) -> MethodEntry:
    """Register a solver method with the port's registry."""
    if not overwrite and entry.name in _REGISTRY:
        raise ValueError(f"method {entry.name!r} is already registered")
    _REGISTRY[entry.name] = entry
    return entry


def solver_method(name: str) -> MethodEntry:
    """Look up a registered method; raises ValueError on unknown names."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"method must be one of {method_names()}, got {name!r}") from None


def method_names() -> Tuple[str, ...]:
    """Registered method names, in registration order."""
    return tuple(_REGISTRY)


def is_registered(name: str) -> bool:
    return name in _REGISTRY


def batchable_methods() -> Tuple[str, ...]:
    """Methods the serving engine may batch across designs."""
    return tuple(n for n, e in _REGISTRY.items() if e.batchable)


def shardable_methods() -> Tuple[str, ...]:
    """Methods with a mesh-sharded backend (serving placement eligibility)."""
    return tuple(n for n, e in _REGISTRY.items() if e.shardable)


def streaming_methods() -> Tuple[str, ...]:
    """Methods that can solve non-resident designs."""
    return tuple(n for n, e in _REGISTRY.items() if e.streams)


def methods_for_precision(precision: str) -> Tuple[str, ...]:
    """Methods whose entry supports ``precision``."""
    return tuple(n for n, e in _REGISTRY.items() if precision in e.precisions)


def describe_methods() -> str:
    """The registry, one ``name  summary`` line a method (CLI help text)."""
    width = max((len(n) for n in _REGISTRY), default=0)
    return "\n".join(f"{e.name:<{width}}  {e.summary}"
                     for e in _REGISTRY.values())


def ensure_precision_supported(spec: SolverSpec) -> MethodEntry:
    """Look up ``spec.method`` and verify it implements ``spec.precision``;
    raises ``UnsupportedSpecError`` otherwise.  Returns the entry."""
    entry = solver_method(spec.method)
    if spec.precision not in entry.precisions:
        raise UnsupportedSpecError(
            f"method {spec.method!r} does not support "
            f"precision={spec.precision!r} (supports {entry.precisions}); "
            f"pick one of methods {methods_for_precision(spec.precision)} "
            f"or precision='fp32'")
    return entry
