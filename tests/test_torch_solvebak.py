"""repro_torch.core.solvebak (Algorithm 1) against repro.core.solvebak on
the CPU: single and multi-RHS, warm starts of either shape, precomputed
norms, the one-sweep helper and random order.

Tolerance: coef and residual to 1e-5 (the two sum in different orders);
n_sweeps exactly where rtol = 0 or the stop is atol-only.  Random order
draws from a ``torch.Generator`` in the port and a PRNG key in JAX, two
different streams, so it is held to the converged solution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvebak as j_solvebak
from repro.core.solvebak import solvebak_onesweep as j_onesweep
from repro_torch.core import solvebak, solvebak_onesweep

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL))


def _system(seed, obs=240, nvars=20, k=None, noise=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(obs, nvars)).astype(np.float32)
    a = rng.normal(size=(nvars,) if k is None else (nvars, k)).astype(np.float32)
    y = (x @ a + noise * rng.normal(size=(obs,) if k is None
                                    else (obs, k))).astype(np.float32)
    return x, a, y


def _both(x, y, **kw):
    tkw = {n: torch.tensor(v) if isinstance(v, np.ndarray) else v
           for n, v in kw.items()}
    jkw = {n: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for n, v in kw.items()}
    return (solvebak(torch.tensor(x), torch.tensor(y), **tkw),
            j_solvebak(jnp.asarray(x), jnp.asarray(y), **jkw))


@pytest.mark.parametrize("k", [None, 3])
def test_cyclic_fixed_budget_matches_jax(k):
    x, _, y = _system(1, k=k)
    r, jr = _both(x, y, max_iter=20)
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual)
    _close(r.history, jr.history, rtol=1e-4, atol=1e-4)
    _close(r.sse, jr.sse, rtol=1e-4, atol=1e-4)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == 20
    assert bool(r.converged) == bool(jr.converged)
    assert tuple(r.coef.shape) == jr.coef.shape
    assert tuple(r.residual.shape) == jr.residual.shape


@pytest.mark.parametrize("k,a0_shape", [(None, "vars"), (3, "vars"),
                                        (3, "vars_k")])
def test_warm_start_matches_jax(k, a0_shape):
    x, a, y = _system(2, k=k)
    a0 = a if a0_shape == "vars_k" or k is None else a[:, 0]
    a0 = (0.9 * a0).astype(np.float32)
    r, jr = _both(x, y, max_iter=10, a0=a0)
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == 10


def test_precomputed_norms_and_rtol_stop():
    x, a, y = _system(3, noise=0.0)
    cn = np.einsum("ij,ij->j", x, x).astype(np.float32)
    r, jr = _both(x, y, max_iter=200, rtol=1e-6, cn=cn)
    assert abs(int(r.n_sweeps) - int(jr.n_sweeps)) <= 1
    assert int(r.n_sweeps) < 200
    _close(r.coef, jr.coef)
    _close(r.coef, a, rtol=1e-4, atol=1e-4)


def test_atol_only_stops_on_the_same_sweep():
    x, _, y = _system(4, noise=0.0)
    r, jr = _both(x, y, max_iter=200, atol=1e-3)
    assert int(r.n_sweeps) == int(jr.n_sweeps) < 200
    assert bool(r.converged) and bool(jr.converged)
    _close(r.coef, jr.coef)


def test_zero_column_is_inert():
    x, _, y = _system(5)
    x[:, 3] = 0.0
    r, jr = _both(x, y, max_iter=15)
    assert float(r.coef[3]) == 0.0
    _close(r.coef, jr.coef)


def test_onesweep_matches_jax():
    x, _, y = _system(6)
    a = np.zeros(20, np.float32)
    ta, te = solvebak_onesweep(torch.tensor(x), torch.tensor(y),
                               torch.tensor(a), torch.tensor(y))
    ja, je = j_onesweep(jnp.asarray(x), jnp.asarray(y), jnp.asarray(a),
                        jnp.asarray(y))
    _close(ta, ja)
    _close(te, je)
    r = solvebak(torch.tensor(x), torch.tensor(y), max_iter=1)
    _close(ta, r.coef)


@pytest.mark.parametrize("k", [None, 2])
def test_random_order_converges_to_jax(k):
    x, a, y = _system(7, k=k, noise=0.0)
    r = solvebak(torch.tensor(x), torch.tensor(y), max_iter=60,
                 order="random", generator=torch.Generator().manual_seed(5))
    jr = j_solvebak(jnp.asarray(x), jnp.asarray(y), max_iter=60,
                    order="random", key=jax.random.PRNGKey(5))
    _close(r.coef, jr.coef)
    _close(r.coef, a, rtol=1e-4, atol=1e-4)
    _close(r.residual, jr.residual)


def test_random_order_reproduces_and_differs_from_cyclic():
    x, _, y = _system(8)
    kw = dict(max_iter=3, order="random")
    r1 = solvebak(torch.tensor(x), torch.tensor(y),
                  generator=torch.Generator().manual_seed(11), **kw)
    r2 = solvebak(torch.tensor(x), torch.tensor(y),
                  generator=torch.Generator().manual_seed(11), **kw)
    rc = solvebak(torch.tensor(x), torch.tensor(y), max_iter=3)
    assert torch.equal(r1.coef, r2.coef) and torch.equal(r1.history,
                                                         r2.history)
    assert not torch.equal(r1.coef, rc.coef)


def test_validation_matches_jax():
    x, _, y = _system(9)
    tx, ty = torch.tensor(x), torch.tensor(y)
    for fn, xx, yy in ((solvebak, tx, ty),
                       (j_solvebak, jnp.asarray(x), jnp.asarray(y))):
        with pytest.raises(ValueError, match="requires a"):
            fn(xx, yy, order="random")
        with pytest.raises(ValueError, match="unknown order"):
            fn(xx, yy, order="zigzag")
        with pytest.raises(ValueError, match="a0 must be"):
            fn(xx, yy, a0=xx[:5, 0])
        with pytest.raises(ValueError, match="x must be 2D"):
            fn(xx[:, 0], yy)
