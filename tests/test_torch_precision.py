"""Mixed precision on the port (``SolverSpec.precision`` /
``refine_sweeps``) against the JAX package, class by class as
``tests/test_precision.py``.

JAX's ``fused_solve``, ``stream_solve`` and ``cd_sweep`` (its Pallas
kernels) raise on this tree's jax, so JAX runs what does run there: its
plain solvers and ``prepare(...).x_bf16_for``.  A bf16 solve is the plain
solver on x rounded to bf16 with the fp32 design's column norms
(``solvebakp(mode="jacobi")`` for Algorithm 2, ``solvebak`` for
Algorithm 1); a ``bf16_fp32acc`` solve is that, then the plain solver on
the fp32 x from its coefficients for ``refine_sweeps`` sweeps.  Coef and
residual agree to 1e-5 of their largest magnitude (at least 1); at rtol 0
every sweep runs, so ``n_sweeps`` agrees exactly.  Dispatch, which the
JAX dispatch tests cannot show on this jax, is held to the rule of JAX's
``core/methods.py`` as written.  Inputs are made from a seed with numpy.
"""
import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.solvebak import solvebak as j_solvebak
from repro.core.solvebakp import solvebakp as j_solvebakp
from repro.core.types import column_norms_sq as j_column_norms_sq
import repro_torch.core as T
from repro_torch.core.types import column_norms_sq, column_norms_sq_t
from repro_torch.kernels import _build
from repro_torch.kernels.cd_sweep import (bakp_plan, bakp_sweep_plain,
                                          cd_sweep_plain, check_kernel_args)
from repro_torch.kernels.fused_solve import (fused_solve_plain,
                                             fused_working_set_bytes,
                                             solve_init)
from repro_torch.kernels.stream_solve import (stream_fits, stream_smem_bytes,
                                              stream_solve_plain)
from repro_torch.obs import consume_dispatch, dispatch_counts, fallback_counts

TOL = 1e-5
FUSED = ("bakp_fused", "bak_fused")
_cd = importlib.import_module("repro_torch.kernels.cd_sweep")


def _np(t):
    return t.detach().cpu().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def _close(a, b, tol=TOL, scale=None):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    ref = np.abs(b if scale is None else _np(scale)).max()
    assert np.abs(a - b).max() <= tol * max(1.0, float(ref))


def _max_err(got, want):
    return float(np.max(np.abs(_np(got) - _np(want))))


def _well_conditioned(seed, obs=512, nvars=64, k=None):
    """Design with singular values in [1, 2] (as JAX's test and
    ``benchmarks/solver_precision.py``), consistent y and the truth."""
    rng = np.random.default_rng(seed)
    q1 = np.linalg.qr(rng.normal(size=(obs, nvars)))[0]
    q2 = np.linalg.qr(rng.normal(size=(nvars, nvars)))[0]
    x = ((q1 * np.linspace(1.0, 2.0, nvars)) @ q2).astype(np.float32)
    a = rng.normal(size=(nvars,) if k is None else (nvars, k)).astype(
        np.float32)
    return x, a, (x @ a).astype(np.float32)


def _rounded(x, thr):
    """x rounded to bf16 exactly as the JAX handle's quantized tier rounds
    it, as fp32 (obs, vars)."""
    xb = J.prepare(x).x_bf16_for(thr)
    return np.asarray(xb, np.float32).T[:, :x.shape[1]].copy()


def _j_plain(variant, x, y, *, thr, max_iter, rtol, a0, cn_design):
    """JAX's plain solver of ``variant`` on ``x`` with the column norms of
    ``cn_design`` (the fp32 design)."""
    jp = J.prepare(cn_design)
    if variant == "bakp_fused":
        return j_solvebakp(x, y, thr=thr, max_iter=max_iter, rtol=rtol,
                           mode="jacobi", cn=jp.cn_for_thr(thr), a0=a0)
    return j_solvebak(x, y, max_iter=max_iter, rtol=rtol, a0=a0, cn=jp.cn)


def _j_oracle(variant, x, y, *, thr, max_iter, rtol, a0, precision,
              refine):
    """The JAX reference of a ``precision`` solve: the plain solver on the
    bf16-rounded x, then (bf16_fp32acc) ``refine`` fp32 sweeps from its
    coefficients, sweeps summed, histories concatenated, converged OR'd."""
    lp = _j_plain(variant, _rounded(x, thr), y, thr=thr, max_iter=max_iter,
                  rtol=rtol, a0=a0, cn_design=x)
    if precision == "bf16":
        return lp
    pol = _j_plain(variant, x, y, thr=thr, max_iter=refine, rtol=rtol,
                   a0=np.asarray(lp.coef), cn_design=x)
    return pol._replace(
        n_sweeps=int(lp.n_sweeps) + int(pol.n_sweeps),
        converged=bool(lp.converged) or bool(pol.converged),
        history=jnp.concatenate([lp.history, pol.history]))


# ------------------------------------------------------------ spec surface
class TestSpecSurface:
    def test_precisions_match_jax(self):
        assert T.PRECISIONS == J.PRECISIONS == ("fp32", "bf16",
                                                "bf16_fp32acc")
        for p in T.PRECISIONS:
            assert T.methods_for_precision(p) == J.methods_for_precision(p)
        assert set(T.methods_for_precision("bf16")) == {
            "bakp_fused", "bak_fused", "bakp_stream"}

    @pytest.mark.parametrize("method", ["bak", "bakp", "bakp_gram",
                                        "bakp_fused", "bak_fused",
                                        "bakp_stream", "lstsq", "normal",
                                        "bakf"])
    def test_method_precisions_match_jax(self, method):
        assert (T.solver_method(method).precisions
                == J.solver_method(method).precisions)

    @pytest.mark.parametrize("method,precision", [
        ("bakp", "bf16"), ("bakp_stream", "bf16_fp32acc"), ("bak", "bf16"),
        ("lstsq", "bf16_fp32acc")])
    def test_unsupported_pairs_raise_typed(self, method, precision):
        spec = T.SolverSpec(method=method, precision=precision)
        with pytest.raises(T.UnsupportedSpecError, match="does not support"):
            T.ensure_precision_supported(spec)
        x, _, y = _well_conditioned(1, obs=64, nvars=16)
        with pytest.raises(T.UnsupportedSpecError):
            T.prepare(x, spec, device="cpu")
        design = T.prepare(x, T.SolverSpec(method="bakp", thr=8),
                           device="cpu")
        with pytest.raises(T.UnsupportedSpecError):
            design.solve(y, spec=spec)
        assert issubclass(T.UnsupportedSpecError, ValueError)

    def test_malformed_precision_is_value_error(self):
        with pytest.raises(ValueError, match="precision"):
            T.SolverSpec(method="bakp_fused", precision="fp16")

    @pytest.mark.parametrize("method", ["bakp_fused", "bak_fused",
                                        "bakp_stream", "bakp"])
    @pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16_fp32acc"])
    @pytest.mark.parametrize("refine", [None, 9])
    def test_canonical_matches_jax(self, method, precision, refine):
        kw = {} if refine is None else {"refine_sweeps": refine}
        t = T.SolverSpec(method=method, precision=precision, thr=16, **kw)
        j = J.SolverSpec(method=method, precision=precision, thr=16, **kw)
        assert (T.spec.dataclasses.asdict(t.canonical())
                == J.spec.dataclasses.asdict(j.canonical()))


# ---------------------------------------------------------- quantized tier
class TestQuantizedCacheTier:
    def test_x_bf16_for_bit_equal_to_jax(self):
        x, _, _ = _well_conditioned(2, obs=128, nvars=24)
        design = T.prepare(x, device="cpu")
        xb = design.x_bf16_for(16)
        assert xb.dtype == torch.bfloat16 and xb.is_contiguous()
        assert tuple(xb.shape) == (32, 128)   # thr-padded transposed layout
        assert design.x_bf16_for(16) is xb    # memoised
        jxb = J.prepare(x).x_bf16_for(16)
        np.testing.assert_array_equal(xb.float().numpy(),
                                      np.asarray(jxb, np.float32))
        np.testing.assert_array_equal(
            xb.float().numpy(), design.x_t_for(16).bfloat16().float().numpy())

    def test_prepare_hook_warms_quantized_tier(self):
        x, _, _ = _well_conditioned(3, obs=128, nvars=24)
        for method in ("bakp_fused", "bak_fused", "bakp_stream"):
            d32 = T.prepare(x, T.SolverSpec(method=method, thr=8),
                            device="cpu")
            assert 8 in d32._x_t and 8 not in d32._x_bf16
            dbf = T.prepare(x, T.SolverSpec(method=method, thr=8,
                                            precision="bf16"), device="cpu")
            assert 8 in dbf._x_bf16

    def test_non_resident_handle_has_no_quantized_tier(self):
        x, _, _ = _well_conditioned(4, obs=128, nvars=24)
        h = T.prepared_from_arrays(x, resident=False, device="cpu")
        with pytest.raises(T.UnsupportedSpecError, match="non-resident"):
            h.x_bf16_for(8)

    def test_norms_accumulate_fp32_on_bf16_input(self):
        x = np.random.default_rng(5).normal(size=(2048, 8)).astype(np.float32)
        xb = torch.tensor(x).bfloat16()
        got, got_t = column_norms_sq(xb), column_norms_sq_t(xb.T)
        assert got.dtype == torch.float32 and got_t.dtype == torch.float32
        # fp32 sums of 2,048 squares against fp64: well inside 1e-4, where
        # a bf16 accumulation would be off by about 1e-2.
        ref = np.sum(xb.double().numpy() ** 2, axis=0)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4)
        np.testing.assert_allclose(got_t.numpy(), ref, rtol=1e-4)
        jref = j_column_norms_sq(jnp.asarray(x).astype(jnp.bfloat16))
        np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-5)


# --------------------------------------------------- plain kernels on bf16
@pytest.mark.parametrize("obs", [256, 257])
@pytest.mark.parametrize("k", [1, 3])
def test_plain_kernels_widen_bf16_x(obs, k):
    """Each plain version on a bf16 x_t is bit-equal to itself on that x_t
    widened to fp32: the widening is exact and the arithmetic is fp32."""
    rng = np.random.default_rng(6)
    x_t = torch.tensor(rng.normal(size=(32, obs)).astype(np.float32))
    xb = x_t.bfloat16()
    xw = xb.float()
    inv = torch.tensor(rng.uniform(0.5, 1.0, size=32).astype(np.float32))
    inv = inv / obs
    e = torch.tensor(rng.normal(size=(k, obs)).astype(np.float32))
    for fn in (lambda x: cd_sweep_plain(x, e, inv),
               lambda x: bakp_sweep_plain(x, e, inv, block=8, omega=0.9)):
        for a, b in zip(fn(xb), fn(xw)):
            assert torch.equal(a, b)
    y = torch.tensor(rng.normal(size=(obs, k)).astype(np.float32))
    a0 = torch.tensor(rng.normal(size=(32, k)).astype(np.float32))
    kw = dict(block=8, max_iter=4, atol_sse=0.0, rtol=0.0, omega=1.0)
    outs = []
    for x in (xb, xw):
        inv_cn, a0m, e0 = solve_init(x, y, inv, a0, True)
        outs.append((fused_solve_plain(x, inv_cn, e0, a0m, **kw),
                     fused_solve_plain(x, inv_cn, e0, a0m, variant="bak",
                                       **kw),
                     stream_solve_plain(x, inv_cn, e0, a0m, **kw)))
    for got, want in zip(*outs):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# ------------------------------------------------------ numbers against JAX
class TestParityFused:
    @pytest.mark.parametrize("variant", FUSED)
    @pytest.mark.parametrize("k", [None, 4])
    @pytest.mark.parametrize("warm", [False, True])
    @pytest.mark.parametrize("precision", ["bf16", "bf16_fp32acc"])
    def test_matches_jax_oracle(self, variant, k, warm, precision):
        x, a, y = _well_conditioned(7, k=k)
        a0 = None if not warm else (0.8 * a).astype(np.float32)
        spec = T.SolverSpec(method=variant, thr=16, max_iter=40, rtol=0.0,
                            precision=precision, refine_sweeps=6)
        design = T.prepare(x, spec, device="cpu")
        consume_dispatch()
        before = sum(dispatch_counts().values())
        r = design.solve(y, a0=a0)
        assert consume_dispatch() == "fused"
        assert sum(dispatch_counts().values()) == before + 1  # polish: none
        j = _j_oracle(variant, x, y, thr=16, max_iter=40, rtol=0.0, a0=a0,
                      precision=precision, refine=6)
        _close(r.coef, j.coef)
        _close(r.residual, j.residual, scale=y)
        n = 40 if precision == "bf16" else 46
        assert int(r.n_sweeps) == int(j.n_sweeps) == n
        assert r.history.shape[0] == j.history.shape[0] == n
        assert bool(r.converged) == bool(j.converged)
        _close(r.history, j.history, tol=1e-4)

    @pytest.mark.parametrize("variant", FUSED)
    @pytest.mark.parametrize("k", [None, 4])
    @pytest.mark.parametrize("warm", [False, True])
    def test_bf16_and_refined_vs_fp32(self, variant, k, warm):
        """JAX's own bounds, held against the port's fp32 solve."""
        x, a, y = _well_conditioned(8, k=k)
        base = T.SolverSpec(method=variant, thr=16, max_iter=200,
                            rtol=1e-12)
        design = T.prepare(x, base, device="cpu")
        a0 = None if not warm else (0.8 * a).astype(np.float32)
        r32 = design.solve(y, a0=a0)
        rbf = design.solve(y, a0=a0, spec=base.replace(precision="bf16"))
        racc = design.solve(y, a0=a0,
                            spec=base.replace(precision="bf16_fp32acc",
                                              refine_sweeps=8))
        assert _max_err(rbf.coef, r32.coef) <= 1e-2
        assert _max_err(racc.coef, r32.coef) <= 1e-5
        assert racc.history.shape[0] == base.max_iter + 8

    def test_warm_cold_equivalence_of_quantized_tier(self):
        """The bf16 tier is cast once and cached, so repeat solves see the
        same copy and give the same bits."""
        x, _, y = _well_conditioned(9, obs=256, nvars=32)
        spec = T.SolverSpec(method="bakp_fused", thr=16, max_iter=50,
                            precision="bf16")
        design = T.prepare(x, spec, device="cpu")
        xb = design.x_bf16_for(16)
        cold, warm = design.solve(y), design.solve(y)
        assert design.x_bf16_for(16) is xb
        assert torch.equal(cold.coef, warm.coef)

    def test_unpadded_vars_trim_after_polish(self):
        """vars not a multiple of thr: the kernel path pads, the polish
        runs on the padded coefficients and the result is trimmed."""
        x, a, y = _well_conditioned(10, obs=256, nvars=40)
        spec = T.SolverSpec(method="bakp_fused", thr=16, max_iter=30,
                            precision="bf16_fp32acc", refine_sweeps=5)
        r = T.prepare(x, spec, device="cpu").solve(y, a0=0.5 * a)
        j = _j_oracle("bakp_fused", x, y, thr=16, max_iter=30, rtol=0.0,
                      a0=0.5 * a, precision="bf16_fp32acc", refine=5)
        assert tuple(r.coef.shape) == (40,)
        _close(r.coef, j.coef)
        _close(r.residual, j.residual, scale=y)


# ----------------------------------------------------- dispatch, as written
class TestDispatchPaths:
    @pytest.mark.parametrize("variant", FUSED)
    def test_bf16_only_fits_fused_dispatches_fused(self, variant,
                                                   monkeypatch):
        """Budget between the bf16 and the fp32 working set: fused at
        bf16 and bf16_fp32acc, the plain path (xla/vmem) at fp32."""
        x, a, y = _well_conditioned(11, obs=512, nvars=64)
        need32 = fused_working_set_bytes(64, 512, 1, 4, max_iter=40)
        need16 = fused_working_set_bytes(64, 512, 1, 2, max_iter=40)
        monkeypatch.setattr(_cd, "ON_CHIP_BUDGET_BYTES",
                            (need32 + need16) // 2)
        spec = T.SolverSpec(method=variant, thr=16, max_iter=40, rtol=0.0)
        design = T.prepare(x, spec, device="cpu")
        consume_dispatch()
        vmem = fallback_counts().get((variant, "vmem"), 0)
        r32 = design.solve(y)
        assert consume_dispatch() == "xla"
        assert fallback_counts().get((variant, "vmem"), 0) == vmem + 1
        rbf = design.solve(y, spec=spec.replace(precision="bf16"))
        assert consume_dispatch() == "fused"
        racc = design.solve(y, spec=spec.replace(precision="bf16_fp32acc",
                                                 refine_sweeps=8))
        assert consume_dispatch() == "fused"
        assert fallback_counts().get((variant, "vmem"), 0) == vmem + 1
        _close(rbf.coef, _j_oracle(variant, x, y, thr=16, max_iter=40,
                                   rtol=0.0, a0=None, precision="bf16",
                                   refine=0).coef)
        assert _max_err(racc.coef, r32.coef) <= 1e-5
        np.testing.assert_allclose(_np(racc.coef), a, rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("variant", FUSED)
    @pytest.mark.parametrize("k", [None, 3])
    def test_bf16_over_budget_streams_persweep(self, variant, k,
                                               monkeypatch):
        """Over the budget even at bf16: the per-sweep loop on the bf16
        copy (persweep/vmem), never the fp32 plain path; the polish
        records nothing and recovers fp32 accuracy."""
        x, a, y = _well_conditioned(12, obs=512, nvars=64, k=k)
        spec = T.SolverSpec(method=variant, thr=16, max_iter=40, rtol=0.0)
        design = T.prepare(x, spec, device="cpu")
        r32 = design.solve(y)
        monkeypatch.setattr(_cd, "ON_CHIP_BUDGET_BYTES", 1024)
        consume_dispatch()
        vmem = fallback_counts().get((variant, "vmem"), 0)
        rbf = design.solve(y, spec=spec.replace(precision="bf16"))
        assert consume_dispatch() == "persweep"
        j = _j_oracle(variant, x, y, thr=16, max_iter=40, rtol=0.0, a0=None,
                      precision="bf16", refine=0)
        _close(rbf.coef, j.coef)
        _close(rbf.residual, j.residual, scale=y)
        before = sum(dispatch_counts().values())
        racc = design.solve(y, spec=spec.replace(precision="bf16_fp32acc",
                                                 refine_sweeps=8))
        assert consume_dispatch() == "persweep"
        assert sum(dispatch_counts().values()) == before + 1
        assert fallback_counts().get((variant, "vmem"), 0) == vmem + 2
        assert int(racc.n_sweeps) == 48 and racc.history.shape[0] == 48
        assert _max_err(racc.coef, r32.coef) <= 1e-5

    def test_max_iter_zero_takes_plain_path_at_bf16(self):
        x, _, y = _well_conditioned(13, obs=128, nvars=16)
        spec = T.SolverSpec(method="bakp_fused", thr=8, max_iter=0,
                            precision="bf16")
        consume_dispatch()
        r = T.prepare(x, spec, device="cpu").solve(y)
        assert consume_dispatch() == "xla"
        assert int(r.n_sweeps) == 0

    @pytest.mark.parametrize("k", [None, 3])
    @pytest.mark.parametrize("warm", [False, True])
    def test_stream_bf16_resident_and_host(self, k, warm):
        """bakp_stream at bf16: a resident handle streams the bf16 copy
        (``stream``, the bf16 numbers); a non-resident one takes the
        host-block loop on fp32 blocks (``stream_host``, the fp32
        numbers)."""
        x, a, y = _well_conditioned(14, obs=256, nvars=48, k=k)
        a0 = None if not warm else (0.8 * a).astype(np.float32)
        spec = T.SolverSpec(method="bakp_stream", thr=16, max_iter=30,
                            rtol=0.0, precision="bf16")
        design = T.prepare(x, spec, device="cpu")
        consume_dispatch()
        r = design.solve(y, a0=a0)
        assert consume_dispatch() == "stream"
        j = _j_oracle("bakp_fused", x, y, thr=16, max_iter=30, rtol=0.0,
                      a0=a0, precision="bf16", refine=0)
        _close(r.coef, j.coef)
        _close(r.residual, j.residual, scale=y)
        h = T.prepared_from_arrays(x, resident=False, spec=spec,
                                   device="cpu")
        rh = h.solve(y, a0=a0)
        assert consume_dispatch() == "stream_host"
        j32 = j_solvebakp(x, y, thr=16, max_iter=30, mode="jacobi", a0=a0)
        _close(rh.coef, j32.coef)
        _close(rh.residual, j32.residual, scale=y)

    def test_stream_bf16_over_the_ring_runs_persweep(self, monkeypatch):
        x, _, y = _well_conditioned(15, obs=256, nvars=32)
        monkeypatch.setattr(_cd, "SMEM_PER_CTA_BYTES", 1024)
        spec = T.SolverSpec(method="bakp_stream", thr=16, max_iter=20,
                            precision="bf16")
        consume_dispatch()
        r = T.prepare(x, spec, device="cpu").solve(y)
        assert consume_dispatch() == "persweep"
        j = _j_oracle("bakp_fused", x, y, thr=16, max_iter=20, rtol=0.0,
                      a0=None, precision="bf16", refine=0)
        _close(r.coef, j.coef)


# -------------------------------------------------------------------- plans
class TestPlans:
    def test_fused_plan_keeps_a_bf16_slice_twice_as_wide(self):
        """16,384 x 512 at k 8 (thr 128): a bf16 slice of 512 x 160
        positions fits a CTA beside the exchange, an fp32 one does not."""
        p16 = bakp_plan("fused", 16_384, 8, 128, nvars=512, itemsize=2)
        p32 = bakp_plan("fused", 16_384, 8, 128, nvars=512, itemsize=4)
        assert (p16.x_in, p16.L, p16.ctas) == ("shared", 160, 112)
        assert p32.x_in == "ring"
        assert p16.smem == (_cd.bakp_exchange_bytes(128, 8, 16)
                            + (2 * 512 + 4 * 8) * 160)
        assert p16.smem <= _cd.SMEM_PER_CTA_BYTES
        # The ring and the per-sweep stages count x at its itemsize too.
        r16 = bakp_plan("fused", 16_384, 8, 128, nvars=2048, itemsize=2)
        assert r16.x_in == "ring" and r16.smem == (
            _cd.bakp_exchange_bytes(128, 8, 16) + (2 * 2 * 128 + 32) * r16.L)
        s16 = bakp_plan("sweep", 262_144, 8, 256, itemsize=2)
        s32 = bakp_plan("sweep", 262_144, 8, 256, itemsize=4)
        assert s16.stages >= s32.stages

    @pytest.mark.parametrize("itemsize", [2, 4])
    @pytest.mark.parametrize("obs,k,block", [(16_384, 8, 128),
                                             (16_384, 1, 128),
                                             (262_144, 8, 256),
                                             (50_000, 4, 64)])
    def test_stream_fits_agrees_with_the_plan(self, itemsize, obs, k, block):
        plan = bakp_plan("stream", obs, k, block, itemsize=itemsize)
        assert stream_smem_bytes(obs, k, itemsize, block=block) == plan.smem
        assert plan.smem == (_cd.bakp_exchange_bytes(block, k, plan.cluster)
                             + itemsize * 2 * block * plan.L + 4 * k * plan.L)
        assert stream_fits(64, obs, k, itemsize, block=block) == (
            plan.smem <= _cd.SMEM_PER_CTA_BYTES)

    def test_stream_fits_admits_more_at_bf16(self):
        # 32,768 obs at thr 128, k 1 (L = 320 on 112 CTAs): an fp32 ring
        # is over a CTA's shared memory, a bf16 one fits.
        assert not stream_fits(1024, 32_768, 1, 4, block=128)
        assert stream_fits(1024, 32_768, 1, 2, block=128)

    @pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                       torch.int32])
    def test_kernel_args_refuse_other_dtypes(self, dtype):
        x_t = torch.zeros((16, 64), dtype=dtype)
        with pytest.raises(TypeError, match="fp32 or bf16"):
            check_kernel_args(x_t, 1, 8)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_kernel_args_take_fp32_and_bf16(self, dtype):
        check_kernel_args(torch.zeros((16, 64), dtype=dtype), 1, 8,
                          torch.zeros(16))

    def test_bf16_launches_count_apart(self):
        assert _build.launch_key("fused_solve", 4) == "fused_solve"
        assert _build.launch_key("fused_solve", 2) == "fused_solve_bf16"
        assert set(_build.launch_counts(2)) == {
            n + "_bf16" for n in _build.SIGNATURES}
        # One C entry a kernel: x untyped, then its element size.
        for n in _build.SIGNATURES:
            launch = [fn for fn in _build.SIGNATURES[n]
                      if fn.endswith("_launch")]
            assert len(launch) == 1
            assert _build.SIGNATURES[n][launch[0]][:2] == [ctypes.c_void_p,
                                                           ctypes.c_int]
        with pytest.raises(ValueError):
            _build.launch_key("fused_solve", 8)
