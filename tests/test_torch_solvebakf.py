"""repro_torch.core.solvebakf (Algorithm 3), the stepwise baseline and the
column preconditioning against the JAX package on the CPU.

Planted systems with well-separated scores give the same selection order
exactly; coef, sse_path and residual agree to 1e-5 (relative to the
largest magnitude of each).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precondition import normalize_columns as j_normalize
from repro.core.precondition import unscale_coef as j_unscale
from repro.core.solvebakf import solvebakf as j_solvebakf
from repro.core.solvebakf import stepwise_regression_baseline as j_stepwise
from repro_torch.core import (SelectResult, normalize_columns, solvebakf,
                              stepwise_regression_baseline, unscale_coef)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel_close(a, b, tol=1e-5):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.nanmax(np.abs(b))))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def _planted(seed, obs=400, nvars=24, support=(3, 11, 17, 5),
             weights=(8.0, -5.0, 3.0, 1.5), noise=0.01):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(obs, nvars)).astype(np.float32)
    a = np.zeros(nvars, np.float32)
    a[list(support)] = weights
    y = (x @ a + noise * rng.normal(size=obs)).astype(np.float32)
    return x, y, support


@pytest.mark.parametrize("max_feat,refit_thr", [(4, 16), (6, 4)])
def test_solvebakf_matches_jax(max_feat, refit_thr):
    x, y, support = _planted(0)
    r = solvebakf(torch.tensor(x), torch.tensor(y), max_feat=max_feat,
                  refit_sweeps=8, refit_thr=refit_thr)
    jr = j_solvebakf(jnp.asarray(x), jnp.asarray(y), max_feat=max_feat,
                     refit_sweeps=8, refit_thr=refit_thr)
    assert isinstance(r, SelectResult)
    assert r.selected.dtype == torch.int32
    np.testing.assert_array_equal(_np(r.selected), np.asarray(jr.selected))
    assert list(_np(r.selected)[:4]) == list(support)
    _rel_close(r.coef, jr.coef)
    _rel_close(r.sse_path, jr.sse_path)
    _rel_close(r.residual, jr.residual)
    assert np.all(np.diff(_np(r.sse_path)) <= 1e-3 * _np(r.sse_path)[0])


def test_solvebakf_full_selection_recovers_the_solution():
    """Past the planted support the scores are rounding noise, so only the
    support's order is compared; the coefficients are compared per column."""
    x, y, support = _planted(1, nvars=12, support=(9, 0, 4),
                             weights=(-3., 2., 1.), noise=0.0)
    r = solvebakf(torch.tensor(x), torch.tensor(y), max_feat=12,
                  refit_sweeps=20, refit_thr=12)
    jr = j_solvebakf(jnp.asarray(x), jnp.asarray(y), max_feat=12,
                     refit_sweeps=20, refit_thr=12)
    np.testing.assert_array_equal(_np(r.selected)[:3],
                                  np.asarray(jr.selected)[:3])
    assert list(_np(r.selected)[:3]) == list(support)
    assert sorted(_np(r.selected).tolist()) == list(range(12))
    coef = np.zeros(12, np.float32)
    coef[_np(r.selected)] = _np(r.coef)
    jcoef = np.zeros(12, np.float32)
    jcoef[np.asarray(jr.selected)] = np.asarray(jr.coef)
    _rel_close(coef, jcoef)
    _rel_close(r.residual, jr.residual)


def test_stepwise_baseline_matches_jax():
    x, y, support = _planted(2, obs=200, nvars=10, support=(1, 7, 4),
                             weights=(4.0, -2.0, 1.0))
    r = stepwise_regression_baseline(torch.tensor(x), torch.tensor(y),
                                     max_feat=4)
    jr = j_stepwise(jnp.asarray(x), jnp.asarray(y), max_feat=4)
    np.testing.assert_array_equal(_np(r.selected), np.asarray(jr.selected))
    assert list(_np(r.selected)[:3]) == list(support)
    _rel_close(r.coef, jr.coef)
    _rel_close(r.sse_path, jr.sse_path, tol=1e-4)
    _rel_close(r.residual, jr.residual)


def test_bakf_and_stepwise_pick_the_same_planted_support():
    x, y, support = _planted(3)
    f = solvebakf(torch.tensor(x), torch.tensor(y), max_feat=4)
    s = stepwise_regression_baseline(torch.tensor(x), torch.tensor(y),
                                     max_feat=4)
    assert set(_np(f.selected).tolist()) == set(support)
    assert set(_np(s.selected).tolist()) == set(support)


def test_normalize_and_unscale_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(50, 6)) * np.array([1, 10, 0.1, 3, 1, 7])
         ).astype(np.float32)
    x[:, 4] = 0.0                                  # zero column kept as-is
    xn, sc = normalize_columns(torch.tensor(x))
    jxn, jsc = j_normalize(jnp.asarray(x))
    _rel_close(xn, jxn)
    _rel_close(sc.scale, jsc.scale)
    assert float(sc.scale[4]) == 1.0
    norms = _np((xn * xn).sum(0))
    np.testing.assert_allclose(norms[[0, 1, 2, 3, 5]], 1.0, rtol=1e-5)
    coef = rng.normal(size=6).astype(np.float32)
    _rel_close(unscale_coef(torch.tensor(coef), sc),
               j_unscale(jnp.asarray(coef), jsc))
    assert xn.dtype == torch.float32
