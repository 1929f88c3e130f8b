"""Shape bucketing, padding and design grouping for the serving engine.

Counterpart of ``repro.serve.batching``.  Requests are padded up to
power-of-two **buckets**, as in the JAX package (where the bucket bounds
the jit compile cache): here it bounds the distinct shapes the kernels'
launch plans and the batch solves see, and it keeps the port's grouping,
padding and padding-corrected tolerances those of the JAX engine, so both
engines solve the same padded systems.  Zero padding is exact for least
squares:

  * extra zero *rows* contribute nothing to any inner product ⟨x_j, e⟩ or
    column norm, so the normal equations are unchanged;
  * extra zero *columns* have zero norm — ``safe_inv`` pins their updates to
    0 (and ``mode="gram"``'s ridge keeps the block factorisation well-posed),
    so their coefficients stay exactly 0 and are stripped on the way out;
  * extra zero *right-hand sides* (multi-RHS k-padding) solve the trivial
    system with an all-zero coefficient column.

Grouping is deterministic: groups are keyed in first-seen submission order
(python dict insertion order), so a fixed request list always produces the
same buckets, the same groups and the same intra-group ordering.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import repro_torch.core.methods  # noqa: F401  (populates the registry)
from repro_torch.core.prepare import design_fingerprint as _core_fingerprint
from repro_torch.core.spec import SolverSpec, method_names, solver_method
from repro_torch.serve.types import SolveRequest

Bucket = Tuple[int, int]


def _host(v) -> np.ndarray:
    """``v`` as a host numpy array (a torch tensor on any device is copied
    to host memory)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _registered(method: str) -> bool:
    try:
        solver_method(method)
    except ValueError:
        return False
    return True


def prepare_request(req: SolveRequest, *,
                    fingerprint: bool = False) -> SolveRequest:
    """Validate a request and normalise its arrays, in place.

    Called by ``SolverServeEngine.submit`` / ``serve``; ``x``, ``y`` and
    ``a0`` may be numpy arrays or torch tensors on any device.  ``y`` and
    ``a0`` become host numpy (padding and stacking run on the host).  A
    tensor ``x`` stays where it is: a design already on the card is not
    copied to the host, and the design cache builds from it on a miss
    (only a missing ``design_key`` makes the fingerprint read its bytes).
    With ``fingerprint=True`` the design is hashed here too.  Idempotent:
    a prepared request passes through unchanged.

    A request carrying an explicit ``SolveRequest.spec`` has its legacy
    mirror fields (method/max_iter/atol/rtol/thr) synced from it, so code
    that still reads those sees the authoritative values.
    """
    if not isinstance(req.x, torch.Tensor):
        req.x = np.asarray(req.x)
    x = req.x
    if x.ndim != 2:
        raise ValueError(f"request x must be 2D (obs, vars), got {x.shape}")
    y = req.y = _host(req.y)
    if y.ndim != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(
            f"request y must be (obs,) matching x rows, got {y.shape} "
            f"for x {x.shape}")
    if req.a0 is not None:
        a0 = req.a0 = _host(req.a0).astype(np.float32, copy=False)
        if a0.shape != (x.shape[1],):
            raise ValueError(
                f"request a0 must be (vars,) = ({x.shape[1]},) matching x "
                f"columns, got {a0.shape}")
    if req.spec is not None:  # spec wins; mirror for legacy readers
        req.method = req.spec.method
        req.max_iter = req.spec.max_iter
        req.atol = req.spec.atol
        req.rtol = req.spec.rtol
        req.thr = req.spec.thr
    if not _registered(req.method):
        raise ValueError(
            f"method must be one of {method_names()}, got {req.method!r}")
    if req.deadline_s is not None and req.deadline_s <= 0:
        raise ValueError(f"deadline_s must be positive, got {req.deadline_s}")
    if fingerprint and req.design_key is None:
        req.design_key = design_fingerprint(x)
    return req


def next_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two ≥ max(n, floor)."""
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


def bucket_shape(obs: int, nvars: int, *, min_obs: int = 8,
                 min_vars: int = 8) -> Bucket:
    """Padded (obs, vars) bucket for a request shape."""
    return next_pow2(obs, min_obs), next_pow2(nvars, min_vars)


def pad_x(x, bucket: Bucket):
    """Zero-pad a design matrix up to ``bucket``, in fp32: fp32 numpy for
    an array, a new fp32 tensor on ``x``'s device for a tensor (so a
    caller's later write to ``x`` cannot reach the cached design)."""
    if isinstance(x, torch.Tensor):
        obs, nvars = x.shape
        x = x.detach().to(torch.float32)
        if (obs, nvars) == tuple(bucket):
            return x.clone()
        return torch.nn.functional.pad(
            x, (0, bucket[1] - nvars, 0, bucket[0] - obs))
    x = np.asarray(x, np.float32)
    obs, nvars = x.shape
    obs_p, vars_p = bucket
    if (obs, nvars) == (obs_p, vars_p):
        return x
    x_pad = np.zeros((obs_p, vars_p), np.float32)
    x_pad[:obs, :nvars] = x
    return x_pad


def pad_y(y: np.ndarray, obs_p: int) -> np.ndarray:
    """Zero-pad a right-hand side (obs,) or (obs, k) to ``obs_p`` rows."""
    y = np.asarray(y, np.float32)
    if y.shape[0] == obs_p:
        return y
    y_pad = np.zeros((obs_p,) + y.shape[1:], np.float32)
    y_pad[: y.shape[0]] = y
    return y_pad


def design_fingerprint(x, *, _prefix: str = "d") -> str:
    """Content fingerprint of a design matrix (delegates to
    ``repro_torch.core.design_fingerprint``, which gives the same bytes the
    same key as the JAX package's).

    Two requests whose ``x`` hash equal are coalesced into one multi-RHS
    solve and share one design-cache entry.  Callers that already know two
    matrices are identical can skip this by setting
    ``SolveRequest.design_key``.
    """
    return _core_fingerprint(x, _prefix=_prefix)


def request_bucket(req: SolveRequest, *, min_obs: int = 8,
                   min_vars: int = 8) -> Bucket:
    obs, nvars = np.shape(req.x)
    return bucket_shape(obs, nvars, min_obs=min_obs, min_vars=min_vars)


def config_key(req: SolveRequest, bucket: Bucket,
               spec: Optional[SolverSpec] = None) -> Tuple:
    """Outer grouping key: ``(bucket, method, canonical spec)``.

    The canonical spec (``SolverSpec.canonical``) resets every field the
    method's registry entry does not consume, so only knob differences that
    would change the result split a group — direct methods ignore every
    iteration knob and any mix of per-tenant max_iter/rtol/thr still
    coalesces into one multi-RHS solve; "bak" additionally ignores ``thr``.
    bucket and method always lead (the engine reads outer[0]/outer[1]).

    ``spec`` overrides the spec derived from the request — the engine passes
    its effective spec (engine-level omega/ridge applied) so grouping always
    matches what will actually be solved.  (The JAX key's trailing mesh
    placement arrives with the port's multi-GPU slice.)
    """
    spec = spec if spec is not None else req.solver_spec()
    return (bucket, spec.method, spec.canonical())


def group_requests(
    requests: List[SolveRequest], *, min_obs: int = 8, min_vars: int = 8,
    spec_fn=None,
) -> Dict[Tuple, Dict[str, List[int]]]:
    """Group request indices: (bucket, method-config) → design key → [idx].

    The outer key (``config_key``) includes exactly the solver knobs the
    method consumes, so only requests that can legally share one solve
    land in the same group; the inner key is the design fingerprint
    (or caller-supplied ``design_key``).  Insertion order of both levels
    follows first occurrence in ``requests``.

    ``spec_fn(request) -> SolverSpec`` (optional) supplies the effective
    spec (the engine passes ``SolverServeEngine.spec_for``) — see
    ``config_key``.
    """
    groups: Dict[Tuple, Dict[str, List[int]]] = {}
    for i, req in enumerate(requests):
        bucket = request_bucket(req, min_obs=min_obs, min_vars=min_vars)
        spec = spec_fn(req) if spec_fn is not None else req.solver_spec()
        key = req.design_key or design_fingerprint(req.x)
        groups.setdefault(config_key(req, bucket, spec),
                          {}).setdefault(key, []).append(i)
    return groups
