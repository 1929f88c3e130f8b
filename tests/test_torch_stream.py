"""The port's streaming path against the JAX package: ``stream_solve``
(its CPU path, the plain version of ``csrc/stream_solve.cu``),
``stream_solve_blocks`` fed the JAX store's own non-resident block source,
non-resident handles built from a JAX non-resident handle's state, the
``bakp_stream`` dispatch and its reroutes, and the H100 fit predicate.

JAX's ``stream_solve`` (its Pallas kernel) raises on this tree's jax, so
the oracles are ``solvebakp(mode="jacobi")``, which shares its block step
and stopping rule, JAX's ``stream_solve_blocks`` and the JAX store's
non-resident ``bakp_stream`` handle, which both run.  Coef agrees to 1e-5
of its largest magnitude (at least 1), the residual to 1e-5 of the
largest |y|.  ``n_sweeps`` agrees exactly at rtol 0 and with an atol
stop; at rtol 1e-10, which is under fp32's resolution, the port's own
execution models stop on the same sweep and JAX within one (see
``test_stream_solve_early_exit_matches_jax``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro import obs as jobs
from repro.core.solvebakp import solvebakp as j_solvebakp
from repro.core.types import safe_inv as j_safe_inv
from repro.kernels import stream_fits as j_stream_fits
from repro.kernels import stream_solve_blocks as j_stream_solve_blocks
from repro.kernels import stream_x_resident_bytes as j_x_resident
from repro.store import DesignStore
from repro.store import HostDesign as JHostDesign
import repro_torch.core as T
from repro_torch.core.types import column_norms_sq_t, safe_inv
from repro_torch.kernels import (fused_solve, solvebakp_stream_kernel,
                                 stream_fits, stream_solve,
                                 stream_solve_blocks, stream_x_resident_bytes)
from repro_torch.kernels.stream_solve import stream_smem_bytes
from repro_torch.obs import consume_dispatch, fallback_counts
from repro_torch import obs
from repro_torch.store import DesignStore as TDesignStore
from repro_torch.store import HostDesign, StoreBlockSource

TOL = 1e-5
RESIDENT_ONLY = ("bak", "bakp", "bakp_gram", "bakp_fused", "bak_fused",
                 "lstsq", "normal", "bakf")
_sm = importlib.import_module("repro_torch.kernels.stream_solve")
_cd = importlib.import_module("repro_torch.kernels.cd_sweep")


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(a, b, tol=TOL, scale=None):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    ref = np.abs(b if scale is None else _np(scale)).max()
    assert np.abs(a - b).max() <= tol * max(1.0, float(ref))


def _system(seed, obs=256, nvars=64, k=None, noise=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(obs, nvars)).astype(np.float32)
    a = rng.normal(size=(nvars,) if k is None else (nvars, k)).astype(np.float32)
    y = (x @ a + noise * rng.normal(size=(obs,) if k is None
                                    else (obs, k))).astype(np.float32)
    return x, a, y


class _NumpyBlocks:
    """A block source over a numpy design, for JAX's host loop."""

    def __init__(self, x):
        self.x, self.shape = x, x.shape

    def num_blocks(self, thr):
        return -(-self.shape[1] // thr)

    def block_t(self, thr, j):
        out = np.zeros((thr, self.shape[0]), np.float32)
        cols = self.x[:, j * thr:(j + 1) * thr].T
        out[:cols.shape[0]] = cols
        return out


def _jax_store_handle(x, key="p"):
    st = DesignStore(device_bytes=1, registry=jobs.MetricsRegistry())
    return st, st.build(key, x)


# ------------------------------------------------------ the kernel's path
@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_stream_solve_matches_jax(nrhs, warm):
    x, a, y = _system(200, k=None if nrhs == 1 else nrhs)
    a0 = (0.5 * a).astype(np.float32) if warm else None
    kw = dict(max_iter=25, rtol=0.0)
    r = stream_solve(torch.tensor(np.ascontiguousarray(x.T)),
                     torch.tensor(y), a0=None if a0 is None
                     else torch.tensor(a0), block=16, **kw)
    jr = j_solvebakp(x, y, thr=16, mode="jacobi", a0=a0, **kw)
    inv = j_safe_inv(jnp.asarray(np.einsum("ij,ij->j", x, x)))
    jb = j_stream_solve_blocks(_NumpyBlocks(x), y, inv_cn=inv, a0=a0,
                               block=16, **kw)
    for ref in (jr, jb):
        _close(r.coef, ref.coef)
        _close(r.residual, ref.residual, scale=y)
        assert int(r.n_sweeps) == int(ref.n_sweeps) == 25
    _close(r.history, jr.history, scale=jr.history)


@pytest.mark.parametrize("nrhs", [1, 2])
def test_stream_solve_early_exit_matches_jax(nrhs):
    x, a, y = _system(201, obs=512, nvars=32, k=None if nrhs == 1 else nrhs,
                      noise=0.0)
    x_t = torch.tensor(np.ascontiguousarray(x.T))
    inv = safe_inv(column_norms_sq_t(x_t))
    # rtol 1e-10 is under fp32's resolution, so the stop fires on the sweep
    # where rounding stops the SSE falling: the port's three execution
    # models (the same torch ops) stop on the same sweep, JAX's solvebakp
    # (its sums in another order) within one.
    kw = dict(max_iter=60, rtol=1e-10)
    r = stream_solve(x_t, torch.tensor(y), block=16, **kw)
    rb = stream_solve_blocks(_NumpyBlocks(x), y, inv_cn=inv, block=16, **kw)
    rf = fused_solve(x_t, torch.tensor(y), block=16, **kw)
    assert int(r.n_sweeps) == int(rb.n_sweeps) == int(rf.n_sweeps) < 60
    _close(rb.coef, r.coef, tol=0.0)
    jr = j_solvebakp(x, y, thr=16, mode="jacobi", **kw)
    assert abs(int(r.n_sweeps) - int(jr.n_sweeps)) <= 1
    assert bool(r.converged) and bool(jr.converged)
    _close(r.coef, jr.coef)
    _close(r.coef, a, tol=1e-4)
    # An atol stop lies well above the rounding: the same sweep as JAX.
    kwa = dict(max_iter=200, atol=1e-3)
    ra = stream_solve(x_t, torch.tensor(y), block=16, **kwa)
    jra = j_solvebakp(x, y, thr=16, mode="jacobi", **kwa)
    assert int(ra.n_sweeps) == int(jra.n_sweeps) < 200
    _close(ra.coef, jra.coef)


def test_stream_solve_rejects_bad_shapes(monkeypatch):
    with pytest.raises(ValueError, match="multiple"):
        stream_solve(torch.zeros(48, 64), torch.zeros(64), block=32)
    with pytest.raises(ValueError, match="max_iter"):
        stream_solve(torch.zeros(64, 64), torch.zeros(64), block=32,
                     max_iter=0)
    monkeypatch.setattr(_cd, "SMEM_PER_CTA_BYTES", 1024)
    with pytest.raises(ValueError, match="shared memory"):
        stream_solve(torch.zeros(64, 64), torch.zeros(64), block=32)


# ------------------------------------------------------- the fit predicate
def test_stream_fits_worked_examples():
    # 16,384 obs on 7 clusters of 16 CTAs (what an H100 holds at once at
    # one CTA per SM), L = 160, thr 128, k 8: the exchange arrays (3 x 16
    # slices of 64 floats, the owned slice and 60 fixed floats, 12,784
    # bytes), a 163,840-byte ring and the 5,120-byte residual slice.
    plan = _sm.stream_plan(16_384, 8, block=128)
    assert (plan.regime, plan.ctas, plan.cluster, plan.clusters, plan.L) == (
        "multi_cluster", 112, 16, 7, 160)
    assert stream_smem_bytes(16_384, 8, 4, block=128) == (
        12_784 + 163_840 + 5_120) == plan.smem
    assert stream_fits(4_096, 16_384, 8, 4, block=128)
    # Phase 2 of chip_smoke.py: 262,144 obs at thr 256 is a 2.4 MB tile per
    # stage per CTA, so the per-sweep path, as JAX routes it too.
    assert _sm.stream_plan(262_144, 8, block=256).L == 2_368
    assert not stream_fits(1_024, 262_144, 8, 4, block=256)
    assert not j_stream_fits(1_024, 262_144, 8, 4, block=256)
    # vars never enters; the x resident on chip is two (block, obs) tiles.
    assert stream_fits(1 << 20, 16_384, 8, 4, block=128)
    for block, obs in ((128, 16_384), (256, 262_144)):
        assert (stream_x_resident_bytes(block, obs, 4)
                == j_x_resident(block, obs, 4))


@pytest.mark.parametrize("cluster", [4, 8, 16])
def test_bakp_plan_arithmetic(monkeypatch, cluster):
    """The Algorithm-2 cluster plan: one cluster while obs needs no more
    CTAs at MIN_OBS_PER_CTA each (halved below that), else as many clusters
    as the card holds, with empty slices in a ragged last cluster; the
    exchange words and the per-sweep kernel's residual placement."""
    monkeypatch.setitem(_cd.BAKP_CLUSTER, "stream", cluster)
    held = _cd.CARD_CLUSTERS[cluster]
    one = _cd.bakp_plan("stream", cluster * 128, 3, 32)
    assert (one.regime, one.ctas, one.clusters, one.L, one.xchg_words) == (
        "single_cluster", cluster, 1, 128, 0)
    half = _cd.bakp_plan("stream", cluster * 128 - 1, 3, 32)
    assert half.ctas == half.cluster == cluster // 2
    many = _cd.bakp_plan("stream", 200_000, 3, 32)
    assert (many.regime, many.cluster, many.clusters) == (
        "multi_cluster", cluster, held)
    assert many.ctas == cluster * held
    assert many.L == -(-(-(-200_000 // many.ctas)) // 32) * 32
    # kp = 4 for k = 3; S = ceil(32·4 / C) rounded to 4; two parities of
    # C·S step words and 2 SSE words a cluster, 64 bits each.
    own = -(-(-(-128 // cluster)) // 4) * 4
    assert _cd.bakp_own(32, 3, cluster) == own
    assert many.xchg_words == 4 * held * (cluster * own + 2)
    assert _cd.bakp_exchange_bytes(32, 3, cluster) == 4 * (
        60 + 3 * cluster * own + own)
    # The phase 3 shape leaves part of the last cluster without obs.
    p3 = _cd.bakp_layout(16_384, cluster=cluster, max_clusters=held)
    assert p3[1] * p3[4] - 16_384 >= 0
    if cluster == 16:
        assert -(-16_384 // p3[4]) == 103 < p3[1] == 112
    # Capped CTAs shrink the cluster; the per-sweep kernel keeps e in
    # shared memory while it fits beside its ring, else in device memory.
    assert _cd.bakp_layout(2_000, cluster=cluster, max_ctas=1)[1:4] == (
        1, 1, 1)
    # The per-sweep kernel has its own cluster size; e stays in shared
    # memory while it fits beside a ring of three chunks.
    assert _cd.bakp_plan("sweep", 262_144, 8, 256).cluster == (
        _cd.BAKP_CLUSTER["sweep"])
    assert _cd.bakp_plan("sweep", 262_144, 8, 256).e_in == "shared"
    assert _cd.bakp_plan("sweep", 1_000_003, 8, 128).e_in == "device"


@pytest.mark.parametrize("const,value", [("SMEM_PER_CTA_BYTES", 4096),
                                         ("MAX_CTAS", 1),
                                         ("MIN_OBS_PER_CTA", 1 << 20)])
def test_resident_handle_streams_and_reroutes(monkeypatch, const, value):
    x, a, y = _system(202, obs=2000, nvars=60, k=2)   # 60 % 32: padded
    a0 = (0.5 * a).astype(np.float32)
    spec = T.SolverSpec(method="bakp_stream", thr=32, max_iter=30)
    p = T.prepare(x, spec, device="cpu")
    r = p.solve(y, a0)
    assert consume_dispatch() == "stream"
    jr = j_solvebakp(x, y, thr=32, mode="jacobi", max_iter=30, a0=a0)
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual, scale=y)
    monkeypatch.setattr(_cd, const, value)
    before = fallback_counts().get(("bakp_stream", "vmem"), 0)
    rf = p.solve(y, a0)
    assert consume_dispatch() == "persweep"
    assert fallback_counts()[("bakp_stream", "vmem")] == before + 1
    _close(rf.coef, jr.coef)
    _close(rf.residual, jr.residual, scale=y)
    assert int(rf.n_sweeps) == int(r.n_sweeps) == 30


def test_ops_entry_dispatch_and_zero_budget():
    x, a, y = _system(203, obs=512, nvars=64)
    x_t = torch.tensor(np.ascontiguousarray(x.T))
    r = solvebakp_stream_kernel(x_t, torch.tensor(y), block=32, max_iter=25)
    assert consume_dispatch() == "stream"
    _close(r.coef, j_solvebakp(x, y, thr=32, mode="jacobi",
                               max_iter=25).coef)
    before = fallback_counts().get(("bakp", "max_iter"), 0)
    r0 = solvebakp_stream_kernel(x_t, torch.tensor(y), block=32, max_iter=0)
    assert consume_dispatch() == "persweep"
    assert fallback_counts()[("bakp", "max_iter")] == before + 1
    assert int(r0.n_sweeps) == 0 and float(r0.coef.abs().max()) == 0.0
    p = T.prepare(x, T.SolverSpec(method="bakp_stream", thr=32, max_iter=0),
                  device="cpu")
    p.solve(y)
    assert consume_dispatch() == "xla"


# ------------------------------------------------------ the host-block path
@pytest.mark.parametrize("nrhs", [1, 2])
def test_blocks_from_jax_store_match_jax_handle(nrhs):
    x, _, y = _system(204, obs=80, nvars=48, k=None if nrhs == 1 else nrhs)
    st, h = _jax_store_handle(x)
    assert h.x_pad is None
    spec = J.SolverSpec(method="bakp_stream", thr=16, max_iter=30)
    jr = h.solve(y, spec=spec)
    inv = torch.tensor(np.asarray(h.inv_cn_for(16)))
    r = stream_solve_blocks(h.blocks, y, inv_cn=inv, block=16, max_iter=30)
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual, scale=y)
    assert int(r.n_sweeps) == int(jr.n_sweeps) == 30
    _close(r.history, jr.history, scale=jr.history)


@pytest.mark.parametrize("stop", [dict(atol=1e-3), dict(rtol=1e-10)])
def test_blocks_warm_tenant_and_early_exit_match_jax(stop):
    """An atol stop lies well above fp32 rounding and lands on JAX's sweep;
    rtol 1e-10 is under it (the stop fires where rounding ends the SSE's
    fall), so there the sweep counts agree within one."""
    x, a, y = _system(205, obs=256, nvars=40, noise=0.0)   # 40 % 16: padded
    st, h = _jax_store_handle(x)
    spec = J.SolverSpec(method="bakp_stream", thr=16, max_iter=100, **stop)
    cold = h.solve(y, spec=spec, tenant_id="t")
    y2 = (y + 0.01 * x.sum(1)).astype(np.float32)
    warm = h.solve(y2, spec=spec, tenant_id="t")
    inv = torch.tensor(np.asarray(h.inv_cn_for(16)))
    kw = dict(inv_cn=inv, block=16, max_iter=100, **stop)
    slack = 0 if "atol" in stop else 1
    r = stream_solve_blocks(h.blocks, y, **kw)
    assert abs(int(r.n_sweeps) - int(cold.n_sweeps)) <= slack
    assert int(r.n_sweeps) < 100 and bool(r.converged)
    assert r.coef.shape == (48,)                     # thr-padded layout
    rw = stream_solve_blocks(h.blocks, y2, a0=r.coef, **kw)
    assert abs(int(rw.n_sweeps) - int(warm.n_sweeps)) <= slack
    assert int(rw.n_sweeps) < int(r.n_sweeps)
    _close(rw.coef[:40], warm.coef)
    _close(rw.residual, warm.residual, scale=y2)
    _close(rw.coef[:40], a + 0.01, tol=1e-3)


@pytest.mark.parametrize("k", [None, 2])
def test_nonresident_handle_from_jax_state(k):
    x, _, y = _system(206, obs=96, nvars=40, k=k, noise=0.0)
    st, h = _jax_store_handle(x, key="nr")
    spec_kw = dict(method="bakp_stream", thr=16, max_iter=200, atol=1e-4)
    h.solve(y, spec=J.SolverSpec(**spec_kw), tenant_id="t0")
    host = st._host["nr"]
    tp = T.prepared_from_arrays(
        host.x_pad, resident=False, cn=np.asarray(h.cn), fingerprint="nr",
        warm={t: np.asarray(c) for t, c in h._warm.items()},
        spec=T.SolverSpec(**spec_kw), device="cpu")
    assert not tp.resident and tp.x_pad is None and tp.shape == (96, 40)
    assert tp.design_key() == "nr"
    _close(tp.warm_coef("t0"), h.warm_coef("t0"))
    y2 = (y + 0.05).astype(np.float32)
    r = tp.solve(y2, tenant_id="t0")
    assert consume_dispatch() == "stream_host"
    jr = h.solve(y2, spec=J.SolverSpec(**spec_kw), tenant_id="t0")
    _close(r.coef, jr.coef)
    _close(r.residual, jr.residual, scale=y2)
    assert int(r.n_sweeps) == int(jr.n_sweeps)
    _close(tp.warm_coef("t0"), h.warm_coef("t0"))


@pytest.mark.parametrize("method", RESIDENT_ONLY)
def test_resident_only_method_on_nonresident_handle_raises(method):
    x, _, y = _system(207, obs=64, nvars=16)
    tp = T.prepared_from_arrays(x, resident=False, device="cpu")
    with pytest.raises(T.UnsupportedSpecError, match="bakp_stream"):
        tp.solve(y, spec=T.SolverSpec(method=method, thr=8))
    st, h = _jax_store_handle(x)
    with pytest.raises(J.UnsupportedSpecError, match="bakp_stream"):
        h.solve(y, spec=J.SolverSpec(method=method, thr=8))


def test_nonresident_accessors_need_x():
    x, _, _ = _system(208, obs=64, nvars=16)
    tp = T.prepared_from_arrays(x, resident=False, device="cpu")
    for call in (lambda: tp.x_t_for(8), lambda: tp.chol_for(8, 1e-6),
                 lambda: tp.design_key()):
        with pytest.raises(T.UnsupportedSpecError, match="non-resident"):
            call()
    _close(tp.cn, np.einsum("ij,ij->j", x, x), scale=tp.cn)
    assert float(tp.inv_cn_for(32)[16:].abs().max()) == 0.0   # padding


def test_host_design_tiles_match_jax_read_cols():
    x, _, _ = _system(209, obs=50, nvars=20)
    host = HostDesign.from_design(x, key="h", pin=False)
    jhost = JHostDesign(key="h", shape=x.shape, x_pad=x)
    assert host.shape == (50, 20) and list(host.x_t) == [20]
    for lo, hi in ((0, 8), (8, 16), (16, 24), (4, 20)):
        _close(host.read_cols(lo, hi), jhost.read_cols(lo, hi), tol=0.0)
    _close(host.cn, np.einsum("ij,ij->j", x, x), scale=host.cn)
    # A non-resident handle's source serves the same tiles off the store's
    # host tier: a whole tile is a view of the record.
    st = TDesignStore(device_bytes=0, device="cpu",
                      registry=obs.MetricsRegistry())
    src = st.build("h", x).blocks
    assert isinstance(src, StoreBlockSource)
    assert src.shape == (50, 20) and src.num_blocks(8) == 3
    for j in range(3):
        tile = src.block_t(8, j)
        assert tile.shape == (8, 50) and tile.dtype == torch.float32
        _close(tile, jhost.read_cols(8 * j, 8 * (j + 1)), tol=0.0)
    full = src.block_t(8, 1)
    assert full.data_ptr() == st._host["h"].x_t[20][8:16].data_ptr()


def test_stream_host_matches_resident_stream():
    x, a, y = _system(210, obs=300, nvars=50, k=3)
    spec = T.SolverSpec(method="bakp_stream", thr=16, max_iter=40, rtol=1e-9)
    a0 = (0.3 * a).astype(np.float32)
    rr = T.prepare(x, spec, device="cpu").solve(y, a0)
    assert consume_dispatch() == "stream"
    rh = T.prepared_from_arrays(x, resident=False, spec=spec,
                                device="cpu").solve(y, a0)
    assert consume_dispatch() == "stream_host"
    _close(rh.coef, rr.coef)
    _close(rh.residual, rr.residual, scale=y)
    assert int(rh.n_sweeps) == int(rr.n_sweeps)
