"""repro_torch.core.solvebakp against repro.core.solvebakp (jacobi and gram
modes), mirroring tests/test_solvebakp.py, plus multi-RHS, ``a0``, ``cn``
and ``chol``.  Inputs made with numpy from a seed go to both packages;
coef and residual agree to 1e-5 of their largest magnitude (at least 1):
fp32 sums run in another order in each package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvebakp as j_solvebakp
from repro.core.solvebakp import block_gram_cholesky as j_chol
from repro_torch.core import block_gram_cholesky, solvebakp
from repro_torch.core.solvebakp import _pad_cols

TOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _system(seed, obs, nvars, k=None, noise=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(obs, nvars)).astype(np.float32)
    a = rng.normal(size=(nvars,) if k is None else (nvars, k)).astype(np.float32)
    y = x @ a
    if noise:
        y = y + noise * rng.normal(size=y.shape)
    return x, y.astype(np.float32), a


def _both(x, y, **kw):
    conv = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    return (solvebakp(torch.tensor(x), torch.tensor(y), **tkw),
            j_solvebakp(jnp.asarray(x), jnp.asarray(y), **conv))


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, float(np.abs(b).max()))


def _parity(r, jr, n_exact=True):
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual)
    if n_exact:
        assert int(r.n_sweeps) == int(jr.n_sweeps)
        assert bool(r.converged) == bool(jr.converged)


@pytest.mark.parametrize("thr", [1, 4, 16, 64])
def test_thr_sweep(thr):
    x, y, a = _system(0, 600, 48)
    r, jr = _both(x, y, thr=thr, max_iter=80, mode="jacobi")
    np.testing.assert_allclose(_np(r.coef), a, rtol=1e-3, atol=1e-3)
    _parity(r, jr)


@pytest.mark.parametrize("thr", [4, 16, 48])
def test_gram_mode(thr):
    x, y, a = _system(1, 600, 48)
    r, jr = _both(x, y, thr=thr, max_iter=40, mode="gram")
    np.testing.assert_allclose(_np(r.coef), a, rtol=1e-3, atol=1e-3)
    _parity(r, jr, n_exact=False)


def test_gram_beats_jacobi_on_correlated():
    rng = np.random.default_rng(2)
    base = rng.normal(size=(500, 8)).astype(np.float32)
    x = np.concatenate(
        [base[:, i // 4: i // 4 + 1] + 0.1 * rng.normal(
            size=(500, 1)).astype(np.float32) for i in range(32)], axis=1)
    y = (x @ rng.normal(size=(32,)).astype(np.float32)).astype(np.float32)
    rj, jrj = _both(x, y, thr=8, max_iter=20, mode="jacobi", omega=0.5)
    rg, _ = _both(x, y, thr=8, max_iter=20, mode="gram")
    assert float(rg.sse) < float(rj.sse)
    _parity(rj, jrj)


def test_non_divisible_vars_padding():
    x, y, a = _system(3, 300, 37)
    r, jr = _both(x, y, thr=16, max_iter=60, mode="gram")
    assert tuple(r.coef.shape) == (37,)
    np.testing.assert_allclose(_np(r.coef), a, rtol=1e-3, atol=1e-3)
    _parity(r, jr, n_exact=False)
    xp, mask, nb = _pad_cols(torch.tensor(x), 16)
    assert tuple(xp.shape) == (300, 48) and nb == 3
    assert float(mask.sum()) == 37


def test_block_gram_cholesky_matches_jax():
    x = np.random.default_rng(4).normal(size=(100, 32)).astype(np.float32)
    chol = block_gram_cholesky(torch.tensor(x).reshape(100, 4, 8), ridge=1e-6)
    assert tuple(chol.shape) == (4, 8, 8)
    np.testing.assert_allclose(
        _np(chol), _np(j_chol(jnp.asarray(x).reshape(100, 4, 8), 1e-6)),
        rtol=1e-4, atol=1e-5)
    g = np.einsum("obt,obs->bts", x.reshape(100, 4, 8),
                  x.reshape(100, 4, 8)) + 1e-6 * np.eye(8)
    np.testing.assert_allclose(_np(chol @ chol.transpose(1, 2)), g,
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("mode", ["jacobi", "gram"])
@pytest.mark.parametrize("a0_kind", [None, "vec", "mat"])
def test_multi_rhs_and_a0(mode, a0_kind):
    x, y, a = _system(5, 300, 24, k=3, noise=0.05)
    a0 = {None: None, "vec": (0.5 * a[:, 0]).astype(np.float32),
          "mat": (0.5 * a).astype(np.float32)}[a0_kind]
    kw = dict(thr=8, max_iter=15, mode=mode)
    if a0 is not None:
        kw["a0"] = a0
    r, jr = _both(x, y, **kw)
    assert tuple(r.coef.shape) == (24, 3) and tuple(r.residual.shape) == (300, 3)
    _parity(r, jr, n_exact=(mode == "jacobi"))


def test_precomputed_cn_and_chol():
    x, y, _ = _system(6, 256, 20, noise=0.05)
    xp, _, nb = _pad_cols(torch.tensor(x), 8)
    cn = (xp * xp).sum(0)
    chol = block_gram_cholesky(xp.reshape(256, nb, 8), 1e-6)
    r1 = solvebakp(torch.tensor(x), torch.tensor(y), thr=8, max_iter=12,
                   mode="gram", cn=cn, chol=chol)
    r2 = solvebakp(torch.tensor(x), torch.tensor(y), thr=8, max_iter=12,
                   mode="gram")
    np.testing.assert_allclose(_np(r1.coef), _np(r2.coef), rtol=1e-6,
                               atol=1e-6)
    # JAX's own factors fed to the port give JAX's answer.
    jxp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 4)))
    jc = j_chol(jxp.reshape(256, nb, 8), 1e-6)
    r3 = solvebakp(torch.tensor(x), torch.tensor(y), thr=8, max_iter=12,
                   mode="gram", chol=torch.tensor(np.asarray(jc)))
    jr = j_solvebakp(jnp.asarray(x), jnp.asarray(y), thr=8, max_iter=12,
                     mode="gram", chol=jc)
    _parity(r3, jr, n_exact=False)


@pytest.mark.parametrize("rtol,atol", [(0.0, 0.0), (0.0, 1e-2), (1e-6, 0.0)])
def test_stopping_matches_jax(rtol, atol):
    x, y, _ = _system(7, 400, 32, noise=0.0)
    r, jr = _both(x, y, thr=8, max_iter=300, rtol=rtol, atol=atol)
    _parity(r, jr, n_exact=(rtol == 0.0))
    if rtol:
        assert abs(int(r.n_sweeps) - int(jr.n_sweeps)) <= 1
    h = _np(r.history)[: int(r.n_sweeps)]
    np.testing.assert_allclose(h, _np(jr.history)[: int(r.n_sweeps)],
                               rtol=1e-3, atol=1e-6)


def test_divergence_reports_not_converged():
    """Jacobi within a block of near-duplicate columns at omega=1 blows up;
    the rule stops on the rise and reports failure, as JAX does."""
    rng = np.random.default_rng(8)
    base = rng.normal(size=(200, 1)).astype(np.float32)
    x = (base + 0.01 * rng.normal(size=(200, 8))).astype(np.float32)
    y = (x @ rng.normal(size=8)).astype(np.float32)
    r, jr = _both(x, y, thr=8, max_iter=50, rtol=1e-6)
    assert not bool(r.converged) and not bool(jr.converged)
    assert int(r.n_sweeps) == int(jr.n_sweeps)


def test_bad_arguments_raise():
    x, y, _ = _system(9, 64, 8)
    with pytest.raises(ValueError, match="a0 must be"):
        solvebakp(torch.tensor(x), torch.tensor(y), a0=torch.zeros(3))
    with pytest.raises(ValueError, match="unknown mode"):
        solvebakp(torch.tensor(x), torch.tensor(y), mode="nope")
    with pytest.raises(ValueError, match="y must be"):
        solvebakp(torch.tensor(x), torch.zeros(64, 2, 2))


@pytest.mark.parametrize("nvars", [24, 20])
def test_batched_gram_factors_from_block_grams(nvars):
    """``solvebakp_batched(mode="gram")`` without factors builds each
    system's from ``block_gram_cholesky`` (one ``mm`` a block), so every
    system solves as ``solvebakp`` does alone and as JAX's vmap of it."""
    import jax
    from repro_torch.core import solvebakp_batched
    systems = [_system(20 + i, 256, nvars, noise=0.05) for i in range(3)]
    xs = np.stack([x for x, _, _ in systems])
    ys = np.stack([y for _, y, _ in systems])
    kw = dict(thr=8, max_iter=12, mode="gram")
    rb = solvebakp_batched(torch.tensor(xs), torch.tensor(ys), **kw)
    jb = jax.vmap(lambda x, y: j_solvebakp(x, y, **kw))(jnp.asarray(xs),
                                                         jnp.asarray(ys))
    _close(rb.coef, jb.coef)
    _close(rb.residual, jb.residual)
    for i, (x, y, _) in enumerate(systems):
        r = solvebakp(torch.tensor(x), torch.tensor(y), **kw)
        _close(rb.coef[i], r.coef)
        np.testing.assert_allclose(_np(rb.history[i]), _np(r.history),
                                   rtol=1e-5, atol=1e-6)
