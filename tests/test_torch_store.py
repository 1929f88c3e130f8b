"""repro_torch.store against repro.store: the tiered design store.

Mirrors ``tests/test_store.py`` — ``TestRegistry``, ``TestTierTransitions``
(with the mesh copies' bytes),
``TestWarmSurvivesEviction``, ``TestStoreEngine`` and the store-backed
cases of ``TestStreamParity`` that ``tests/test_torch_stream.py`` lacks —
plus the tile format, read across the two stores.  Every operation runs on
a JAX ``DesignStore`` and on the port's (``device="cpu"``) in the same
order, and both must agree: the same tier for each key, the same
``StoreStats``, the same bytes per tier, and coefficients within 1e-5 of
their scale (``n_sweeps`` equal only on fixed-sweep and atol-only runs).
The store-backed engines are held against JAX's store engine and against
the port's all-resident engine on the same numpy requests.
"""
import threading
import zlib

import numpy as np
import pytest
import torch

import repro.serve as J
from conftest import make_system
from repro import obs as jobs
from repro.core.solvebakp import solvebakp as j_solvebakp
from repro.core.spec import SolverSpec as JSpec
from repro.core.spec import solver_method as j_solver_method
from repro.core.spec import streaming_methods as j_streaming_methods
from repro.kernels import stream_x_resident_bytes as j_x_resident
from repro.store import DesignStore as JDesignStore
from repro.store.store import _TILE_HEADER as J_TILE_HEADER
from repro.store.store import DiskDesign as JDiskDesign
from repro_torch import obs
from repro_torch.core import prepare
from repro_torch.core.spec import (SolverSpec, UnsupportedSpecError,
                                   solver_method, streaming_methods)
from repro_torch.kernels import (stream_fits, stream_solve_blocks,
                                 stream_x_resident_bytes)
from repro_torch.obs import consume_dispatch
from repro_torch.serve import (AsyncDispatcher, DispatchConfig, ServeConfig,
                               SolveRequest, SolverServeEngine)
from repro_torch.store import DesignStore, DiskDesign, StoreBlockSource
from repro_torch.store.store import _TILE_HEADER, _TILE_MAGIC

TOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(a, b, tol=TOL, scale=None):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    ref = np.abs(b if scale is None else _np(scale)).max()
    assert np.abs(a - b).max() <= tol * max(1.0, float(ref))


def _design(rng, obs_n=96, vars_n=64):
    return rng.normal(size=(obs_n, vars_n)).astype(np.float32)


class _Pair:
    """A JAX store and the port's, built alike and driven alike."""

    def __init__(self, tmp_path=None, disk=False, **kw):
        dirs = {}
        if disk:
            dirs = {s: str(tmp_path / s / "tiles") for s in ("j", "t")}
        self.jreg, self.treg = jobs.MetricsRegistry(), obs.MetricsRegistry()
        self.j = JDesignStore(registry=self.jreg, disk_dir=dirs.get("j"),
                              **kw)
        self.t = DesignStore(registry=self.treg, disk_dir=dirs.get("t"),
                             device="cpu", **kw)

    def __call__(self, op, *args, **kw):
        return getattr(self.j, op)(*args, **kw), getattr(self.t, op)(*args,
                                                                     **kw)

    def agree(self, *keys):
        """Same tier per key, same stats, same bytes and counts per tier."""
        for k in keys:
            assert self.t.tier(k) == self.j.tier(k), k
        assert self.t.stats.as_dict() == self.j.stats.as_dict()
        assert (self.t.device_used(), self.t.host_used(),
                self.t.disk_used()) == (self.j.device_used(),
                                        self.j.host_used(),
                                        self.j.disk_used())
        assert len(self.t) == len(self.j)
        assert sorted(self.t.keys()) == sorted(self.j.keys())


# ------------------------------------------------------------ registry facts
class TestRegistry:
    def test_stream_method_capabilities(self):
        for name in ("bakp_stream", "bakp", "bakp_fused"):
            t, j = solver_method(name), j_solver_method(name)
            assert (t.streams, t.iterative, t.multi_rhs, t.batchable,
                    t.shardable, t.lane) == (j.streams, j.iterative,
                                             j.multi_rhs, j.batchable,
                                             j.shardable, j.lane)
        entry = solver_method("bakp_stream")
        assert entry.streams and entry.lane == "stream"
        assert not entry.shardable and not j_solver_method(
            "bakp_stream").shardable
        assert streaming_methods() == j_streaming_methods() == (
            "bakp_stream",)

    def test_vmem_accounting(self):
        # the streamed x working set is two tiles, independent of vars,
        # as in the JAX package
        for block, obs_n in ((32, 128), (128, 16_384)):
            assert (stream_x_resident_bytes(block, obs_n, 4)
                    == j_x_resident(block, obs_n, 4)
                    == 2 * block * obs_n * 4)
        # vars never enters the streaming kernel's fit (the coefficients
        # stay in device memory)
        assert stream_fits(1 << 20, 128, 1, 4, block=32)
        assert stream_fits(4096, 128, 1, 4, block=32)


# ---------------------------------------------------------- tier transitions
class TestTierTransitions:
    def test_admit_demote_promote_round_trip(self, rng):
        st = _Pair(device_bytes=None)
        x = _design(rng)
        je, te = st("build", "a", x)
        st.agree("a")
        assert st.t.device_used() == x.nbytes
        je.x_t_for(32), te.x_t_for(32)
        st.agree("a")
        assert st.t.device_used() == 2 * x.nbytes

        jsnap, tsnap = st("demote", "a")
        st.agree("a")
        assert st.t.tier("a") == "host"
        assert list(tsnap.x_t) == list(jsnap.x_t) == [32]
        assert tsnap.x_pad is None and tsnap.nbytes == jsnap.nbytes
        _close(tsnap.x_t[32], jsnap.x_t[32], tol=0.0)

        jb, tb = st("promote", "a")
        st.agree("a")
        assert st.t.tier("a") == "device"
        _close(tb.x_pad, x, tol=0.0)
        with tb._lock:
            assert 32 in tb._x_t
        _close(tb.x_t_for(32), jb.x_t_for(32), tol=0.0)

    def test_sharded_copies_count_and_demotion_drops_them(self, rng):
        """A design's mesh copies are device bytes (each storage once: the
        rhs replica four virtual shards share counts once); a demotion
        drops them and a promotion does not rebuild them.  JAX's store on a
        one-device mesh counts the same bytes."""
        from repro_torch.serve import Placement, build_serve_mesh

        st = _Pair(device_bytes=None)
        x = _design(rng)
        je, te = st("build", "a", x)
        jsm, tsm = J.build_serve_mesh("1"), build_serve_mesh("4",
                                                             device="cpu")
        for kind in ("obs_sharded", "rhs_sharded"):
            je.x_for_placement(J.Placement(kind), jsm)
            te.x_for_placement(Placement(kind), tsm)
        st.agree("a")
        assert st.t.device_used() == 3 * x.nbytes
        assert te.resident_lanes() == ("single", "obs_sharded",
                                       "rhs_sharded")
        st("demote", "a")
        assert not te._sharded
        st("promote", "a")
        st.agree("a")
        assert st.t.device_used() == x.nbytes
        tb = st.t.get("a")
        assert tb.resident_lanes() == ("single",)

    def test_byte_budget_demotes_lru_not_mru(self, rng):
        x = _design(rng)
        st = _Pair(device_bytes=2 * x.nbytes)
        keys = "abcd"
        xs = [x] + [_design(rng) for _ in range(3)]
        for k, xx in zip(keys[:3], xs):
            st("build", k, xx)
        st.agree(*keys)
        assert st.t.tier("a") == "host"
        st("get", "b")                  # touch: "c" becomes the LRU
        st("build", "d", xs[3])
        st.agree(*keys)
        assert st.t.tier("c") == "host" and st.t.tier("b") == "device"

    def test_last_entry_never_demoted_by_bytes(self, rng):
        x = _design(rng)
        st = _Pair(device_bytes=x.nbytes // 2)
        je, te = st("build", "solo", x)
        assert te.x_pad is None and je.x_pad is None
        st.agree("solo")
        assert st.t.tier("solo") == "host"
        st2 = _Pair(device_bytes=x.nbytes + 16)
        je2, te2 = st2("build", "solo", x)
        je2.x_t_for(32), te2.x_t_for(32)      # now ~2x over budget
        st2.j.admit("solo", je2), st2.t.admit("solo", te2)
        st2.agree("solo")
        assert st2.t.tier("solo") == "device"

    def test_layouts_take_a_sole_resident_over_budget(self, rng):
        # admission counts x_pad only; a design at 0.6x the budget promoted
        # with its transposed layout holds 1.2x alone, the rest demoted
        small, big = _design(rng), _design(rng, obs_n=160)
        budget = int(big.nbytes / 0.6)
        st = _Pair(device_bytes=budget)
        st("build", "s", small)
        je, te = st("build", "big", big)
        st.agree("s", "big")
        assert st.t.tier("s") == st.t.tier("big") == "device"
        je.x_t_for(32), te.x_t_for(32)
        st("demote", "big")
        st.agree("s", "big")
        assert st.t.tier("big") == "host"
        jb, tb = st("promote", "big")
        assert tb is not None and jb is not None
        st.agree("s", "big")
        assert st.t.tier("big") == "device" and st.t.tier("s") == "host"
        assert st.t.device_used() == 2 * big.nbytes > budget
        _close(tb.x_t_for(32), jb.x_t_for(32), tol=0.0)

    def test_disk_round_trip(self, rng, tmp_path):
        x = _design(rng, 64, 48)
        st = _Pair(tmp_path, disk=True, device_bytes=None, host_bytes=1)
        je, te = st("build", "d1", x)
        je.x_t_for(16), te.x_t_for(16)
        st("demote", "d1")              # host budget of 1 byte -> disk
        st.agree("d1")
        assert st.t.tier("d1") == "disk" and st.t.host_used() == 0
        rec = st.t._disk["d1"]
        assert rec.thr == 16 and rec.nblocks == 3
        assert all(rec.tile_path(j).exists() for j in range(rec.nblocks))
        assert st.t.disk_used() == rec.nbytes == 3 * 16 * 64 * 4
        # the tile files are the JAX store's, byte for byte
        jrec = st.j._disk["d1"]
        for j in range(3):
            assert (rec.tile_path(j).read_bytes()
                    == jrec.tile_path(j).read_bytes())

        jb, tb = st("promote", "d1")
        st.agree("d1")
        assert tb is not None and st.t.tier("d1") == "device"
        _close(tb.x_pad, x, tol=0.0)
        assert not (tmp_path / "t" / "tiles" / "d1").exists()

    def test_no_disk_dir_drops_x_keeps_state(self, rng):
        x = _design(rng, 64, 32)
        st = _Pair(device_bytes=None, host_bytes=1)
        je, te = st("build", "s", x)
        coef = np.ones(32, np.float32)
        je.store_coef("tenant", coef), te.store_coef("tenant", coef)
        st("demote", "s")
        st.agree("s")
        assert st.t.stats.x_drops == 1 and st.t.tier("s") == "none"
        assert st("promote", "s") == (None, None)
        jf, tf = st("build", "s", x)    # rebuild restores the stub's state
        st.agree("s")
        _close(tf.warm_coef("tenant"), jf.warm_coef("tenant"), tol=0.0)

    def test_nonresident_streams_blocks_from_any_tier(self, rng, tmp_path):
        x = _design(rng, 64, 48)
        st = _Pair(tmp_path, disk=True, device_bytes=x.nbytes // 2)
        jh, th = st("build", "big", x)
        st.agree("big")
        assert th.x_pad is None and isinstance(th.blocks, StoreBlockSource)
        assert th.shape == (64, 48) and not th.resident
        for thr in (16, 32):
            for j in range(th.blocks.num_blocks(thr)):
                _close(th.blocks.block_t(thr, j), jh.blocks.block_t(thr, j),
                       tol=0.0)
        # push the bytes to disk; the same handle keeps serving
        st.j._demote_to_disk("big"), st.t._demote_to_disk("big")
        st.agree("big")
        assert st.t.tier("big") == "disk"
        for thr in (16, 32):               # 32: a ragged last tile
            for j in range(th.blocks.num_blocks(thr)):
                _close(th.blocks.block_t(thr, j), jh.blocks.block_t(thr, j),
                       tol=0.0)
        pad_tile = th.blocks.block_t(32, 1)
        assert pad_tile.shape == (32, 64) and not pad_tile[16:].any()

    def test_nonresident_rejects_resident_methods(self, rng):
        st = _Pair(device_bytes=16)
        _, th = st("build", "big", _design(rng))
        with pytest.raises(UnsupportedSpecError, match="bakp_stream"):
            th.solve(np.zeros(96, np.float32),
                     spec=SolverSpec(method="bakp", thr=32))
        with pytest.raises(UnsupportedSpecError, match="non-resident"):
            th.x_t_for(32)

    def test_metrics_tiers_and_moves(self, rng, tmp_path):
        x = _design(rng, 64, 32)
        st = _Pair(tmp_path, disk=True, device_bytes=None, host_bytes=1)
        st("build", "m", x)
        st("demote", "m")               # -> host -> (budget) -> disk
        st("promote", "m")
        for fam, labels in (
                ("store_bytes", [dict(tier=t) for t in
                                 ("device", "host", "disk")]),
                ("store_resident", [dict(tier=t) for t in
                                    ("device", "host", "disk")]),
                ("store_promotions_total", [
                    {"from": "device", "to": "host"},
                    {"from": "host", "to": "disk"},
                    {"from": "disk", "to": "device"}])):
            for lab in labels:
                assert (st.treg.get(fam).value(**lab)
                        == st.jreg.get(fam).value(**lab)), (fam, lab)
        assert st.treg.get("store_resident").value(tier="device") == 1
        assert st.treg.get("store_fetch_latency_seconds").count(
            tier="disk") == 1


# ----------------------------------------------- warm starts survive demotion
class TestWarmSurvivesEviction:
    def test_store_level(self, rng):
        st = _Pair(device_bytes=None)
        x = _design(rng, 64, 32)
        je, te = st("build", "w", x)
        coef = rng.normal(size=32).astype(np.float32)
        for e in (je, te):
            e.store_coef("t0", coef)
            e.chol_for(16, 1e-6)
        home = te.bind_home()
        assert home == je.bind_home()
        st("demote", "w")
        jb, tb = st("promote", "w")
        st.agree("w")
        _close(tb.warm_coef("t0"), coef, tol=0.0)
        _close(tb.warm_coef("t0"), jb.warm_coef("t0"), tol=0.0)
        assert (16, 1e-6) in tb.chol and (16, 1e-6) in jb.chol
        _close(tb.chol[(16, 1e-6)], jb.chol[(16, 1e-6)])
        assert tb.home == jb.home == home

    def test_engine_level_regression(self, rng):
        """A tenant whose design was demoted between solves still
        warm-starts after re-admission, in both engines alike."""
        x, y, _ = make_system(rng, 96, 48)
        design_bytes = 128 * 64 * 4  # padded bucket
        engines = [
            J.SolverServeEngine(
                J.ServeConfig(store_device_bytes=2 * design_bytes),
                registry=jobs.MetricsRegistry()),
            SolverServeEngine(ServeConfig(store_device_bytes=2 * design_bytes),
                              registry=obs.MetricsRegistry(), device="cpu")]
        out = []
        for eng, Req in zip(engines, (J.SolveRequest, SolveRequest)):
            def req(xx, yy, key, tenant=None):
                return Req(x=xx, y=yy, method="bakp", thr=16, max_iter=30,
                           rtol=1e-12, design_key=key, tenant_id=tenant)

            [r0] = eng.serve([req(x, y, "target", "t0")])
            assert r0.error is None
            warm_before = eng.stats.warm_starts
            for i in range(2):
                xi, yi, _ = make_system(np.random.default_rng(50 + i), 96, 48)
                eng.serve([req(xi, yi, f"filler-{i}")])
            assert eng.store.tier("target") == "host"
            [r1] = eng.serve([req(x, y, "target", "t0")])
            assert r1.error is None and r1.warm_start
            assert eng.store.tier("target") == "device"
            assert eng.stats.warm_starts == warm_before + 1
            assert eng.store.stats.promotions_host >= 1
            assert eng.cache.stats.misses == 3  # the three cold builds
            out.append((r0, r1, eng.store.stats.as_dict()))
            eng.shutdown()
        (j0, j1, jst), (t0, t1, tst) = out
        assert tst == jst
        for j, t in ((j0, t0), (j1, t1)):
            _close(t.coef, j.coef)
            _close(t.residual, j.residual, scale=y)


    def test_engine_names_where_a_warm_start_came_from(self, rng):
        """A warm request's ``extra["a0_source"]``: ``"restored"`` when its
        tenant's coefficients came back with a promoted design,
        ``"handle"`` after a solve on the resident handle stored them,
        ``"request"`` for an explicit ``a0``; a cold request has none."""
        x, y, _ = make_system(rng, 96, 48)
        eng = SolverServeEngine(
            ServeConfig(store_device_bytes=2 * 128 * 64 * 4),
            registry=obs.MetricsRegistry(), device="cpu")

        def req(xx, yy, key, tenant=None, a0=None):
            return SolveRequest(x=xx, y=yy, method="bakp", thr=16,
                                max_iter=30, rtol=1e-12, design_key=key,
                                tenant_id=tenant, a0=a0)

        [r0] = eng.serve([req(x, y, "target", "t0")])
        assert not r0.warm_start and r0.extra == {}
        for i in range(2):
            xi, yi, _ = make_system(np.random.default_rng(60 + i), 96, 48)
            eng.serve([req(xi, yi, f"filler-{i}")])
        assert eng.store.tier("target") == "host"
        [r1] = eng.serve([req(x, y, "target", "t0")])
        [r2] = eng.serve([req(x, y, "target", "t0")])
        [r3] = eng.serve([req(x, y, "target", "t1", a0=r0.coef)])
        assert [r.extra.get("a0_source") for r in (r1, r2, r3)] == [
            "restored", "handle", "request"]
        assert all(r.warm_start for r in (r1, r2, r3))
        eng.shutdown()


# ------------------------------------------------------------ solve parity
class TestStreamParity:
    """The port's store-backed non-resident handle (the host-block loop)
    against JAX's on the same design."""

    @pytest.mark.parametrize("nrhs", [1, 2])
    def test_host_block_loop_matches_xla(self, rng, nrhs):
        x, y, _ = make_system(rng, 80, 48)
        if nrhs > 1:
            y = rng.normal(size=(80, nrhs)).astype(np.float32)
        st = _Pair(device_bytes=1)        # force non-resident
        jh, th = st("build", "p", x)
        kw = dict(method="bakp_stream", thr=16, max_iter=30, rtol=0.0)
        res = th.solve(y, spec=SolverSpec(**kw))
        assert consume_dispatch() == "stream_host"
        jres = jh.solve(y, spec=JSpec(**kw))
        ref = j_solvebakp(x, y, thr=16, max_iter=30)
        for r in (jres, ref):
            _close(res.coef, r.coef)
            assert int(res.n_sweeps) == int(r.n_sweeps) == 30
        _close(res.residual, jres.residual, scale=y)

    def test_host_block_loop_warm_and_early_exit(self, rng):
        x, y, _ = make_system(rng, 256, 32)
        st = _Pair(device_bytes=1)
        jh, th = st("build", "w", x)
        # an atol stop lies well above fp32 rounding: JAX's sweep exactly
        kw = dict(method="bakp_stream", thr=16, max_iter=60, atol=1e-4)
        y2 = (y + 0.01 * x.sum(1)).astype(np.float32)
        for yy in (y, y2):
            t = th.solve(yy, spec=SolverSpec(**kw), tenant_id="t")
            j = jh.solve(yy, spec=JSpec(**kw), tenant_id="t")
            assert int(t.n_sweeps) == int(j.n_sweeps) < 60
            _close(t.coef, j.coef)
            _close(t.residual, j.residual, scale=yy)
        assert int(t.n_sweeps) < int(
            th.solve(y2, spec=SolverSpec(**kw)).n_sweeps)   # warm < cold
        _close(th.warm_coef("t"), jh.warm_coef("t"))

    def test_disk_tier_block_loop_matches_jax(self, rng, tmp_path):
        """The same loop fed from the disk tier's memmapped tiles."""
        x, y, _ = make_system(rng, 64, 40)
        st = _Pair(tmp_path, disk=True, device_bytes=1, host_bytes=1)
        jh, th = st("build", "dk", x)
        st.agree("dk")
        assert st.t.tier("dk") == "disk"
        kw = dict(method="bakp_stream", thr=16, max_iter=25, rtol=0.0)
        res = th.solve(y, spec=SolverSpec(**kw))
        jres = jh.solve(y, spec=JSpec(**kw))
        _close(res.coef, jres.coef)
        assert int(res.n_sweeps) == int(jres.n_sweeps) == 25
        assert st.treg.get("store_fetch_latency_seconds").count(
            tier="disk") == 25 * 3

    def test_stream_solve_blocks_direct(self, rng):
        x, y, _ = make_system(rng, 64, 48)
        st = _Pair(device_bytes=1)
        _, th = st("build", "sb", x)
        inv = prepare(x, device="cpu").inv_cn_for(16)
        res = stream_solve_blocks(th.blocks, y, inv_cn=inv, block=16,
                                  max_iter=20)
        ref = j_solvebakp(x, y, thr=16, max_iter=20)
        _close(res.coef, np.asarray(ref.coef))


# ------------------------------------------------------------- tile format
class TestTiles:
    def _disk_record(self, store, tmp_path, x, key):
        e = store.build(key, x)
        e.x_t_for(16)
        store.demote(key)
        assert store.tier(key) == "disk"
        return store._disk[key]

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_tiles_cross_read_bit_for_bit(self, rng, tmp_path, writer):
        """A tile one store writes, the other verifies and reads bit for
        bit: same header (magic, CRC32, bytes), same payload."""
        x = _design(rng, 64, 48)
        kw = dict(device_bytes=None, host_bytes=1,
                  disk_dir=str(tmp_path / "tiles"))
        if writer == "jax":
            rec = self._disk_record(
                JDesignStore(registry=jobs.MetricsRegistry(), **kw),
                tmp_path, x, "xr")
            other = DiskDesign(key="xr", shape=rec.shape,
                               tile_dir=rec.tile_dir, thr=rec.thr,
                               nblocks=rec.nblocks)
        else:
            rec = self._disk_record(
                DesignStore(registry=obs.MetricsRegistry(), device="cpu",
                            **kw), tmp_path, x, "xr")
            other = JDiskDesign(key="xr", shape=rec.shape,
                                tile_dir=rec.tile_dir, thr=rec.thr,
                                nblocks=rec.nblocks)
        assert _TILE_HEADER.format == J_TILE_HEADER.format
        x_t = np.zeros((48, 64), np.float32)
        x_t[:48] = x.T
        for j in range(rec.nblocks):
            raw = rec.tile_path(j).read_bytes()
            magic, crc, nbytes = _TILE_HEADER.unpack_from(raw)
            payload = raw[_TILE_HEADER.size:]
            assert magic == _TILE_MAGIC and nbytes == len(payload)
            assert crc == zlib.crc32(payload)
            for tile in (other.verify_tile(j), other.tile(j),
                         rec.verify_tile(j)):
                assert np.array_equal(_np(tile),
                                      x_t[16 * j:16 * (j + 1)])
        assert np.array_equal(_np(other.read_cols(8, 40)), x_t[8:40])


# ------------------------------------------------------- store-backed engine
def _mape(coef, ref):
    denom = np.maximum(np.abs(ref), 1e-12)
    return float(np.mean(np.abs(coef - ref) / denom))


class TestStoreEngine:
    def test_over_budget_fleet_serves_with_churn(self):
        """64 designs whose bytes exceed the device budget serve to
        completion twice with demotion → promotion churn, in step with
        JAX's store engine (the same tier moves) and within 1e-5 of the
        port's all-resident engine."""
        n_designs, obs_n, vars_n = 64, 48, 24
        design_bytes = 64 * 32 * 4  # padded bucket
        reg = obs.MetricsRegistry()
        store_eng = SolverServeEngine(
            ServeConfig(store_device_bytes=8 * design_bytes,
                        cache_entries=256), registry=reg, device="cpu")
        base_eng = SolverServeEngine(ServeConfig(cache_entries=256),
                                     registry=obs.MetricsRegistry(),
                                     device="cpu")
        j_eng = J.SolverServeEngine(
            J.ServeConfig(store_device_bytes=8 * design_bytes,
                          cache_entries=256),
            registry=jobs.MetricsRegistry())
        systems = [make_system(np.random.default_rng(1000 + i), obs_n,
                               vars_n) for i in range(n_designs)]

        def reqs(Req):
            return [Req(x=x, y=y, method="bakp", thr=8, max_iter=60,
                        rtol=1e-12, design_key=f"d{i}", request_id=f"r{i}")
                    for i, (x, y, _) in enumerate(systems)]

        for _ in range(2):  # the second pass hits demoted designs
            r_store = store_eng.serve(reqs(SolveRequest))
            r_base = base_eng.serve(reqs(SolveRequest))
            r_jax = j_eng.serve(reqs(J.SolveRequest))
            assert store_eng.store.stats.as_dict() == (
                j_eng.store.stats.as_dict())
            assert all(store_eng.store.tier(f"d{i}")
                       == j_eng.store.tier(f"d{i}")
                       for i in range(n_designs))
        assert not [r.error for r in r_store if r.error]
        for s, b, j in zip(r_store, r_base, r_jax):
            _close(s.coef, b.coef)
            _close(s.coef, j.coef)
        assert float(np.mean([_mape(s.coef, b.coef) for s, b in
                              zip(r_store, r_base)])) <= 1e-4
        st = store_eng.store.stats
        assert st.demotions_device > 0 and st.promotions_host > 0
        assert len(store_eng.store) <= 8  # device tier held its budget
        moves = reg.get("store_promotions_total")
        assert moves.value(**{"from": "device", "to": "host"}) > 0
        assert moves.value(**{"from": "host", "to": "device"}) > 0
        assert (store_eng.cache.stats.as_dict()
                == j_eng.cache.stats.as_dict())
        for eng in (store_eng, base_eng, j_eng):
            eng.shutdown()

    def test_mesh_store_engine_holds_sharded_copies_in_budget(self):
        """A store engine on a mesh: obs-sharded designs bring their sharded
        copy into the device tier's bytes, the tier stays within a budget
        of two designs (x + copy) after every flush while a third demotes
        and promotes, and every request matches the mesh-less engine."""
        from repro_torch.serve import PlacementPolicy, build_serve_mesh

        obs_n, vars_n = 128, 32
        budget = 2 * 2 * obs_n * vars_n * 4
        policy = PlacementPolicy(obs_shard_min_cells=obs_n * vars_n)
        store_eng = SolverServeEngine(
            ServeConfig(store_device_bytes=budget, placement_policy=policy),
            mesh=build_serve_mesh("4", device="cpu"),
            registry=obs.MetricsRegistry())
        base_eng = SolverServeEngine(ServeConfig(), device="cpu",
                                     registry=obs.MetricsRegistry())
        systems = [make_system(np.random.default_rng(2000 + i), obs_n,
                               vars_n) for i in range(3)]
        for rnd in range(2):
            for i, (x, y, _) in enumerate(systems):
                reqs = [SolveRequest(x=x, y=y * (1 + t), method="bakp",
                                     thr=8, max_iter=80, rtol=1e-12,
                                     design_key=f"d{i}",
                                     tenant_id=f"d{i}-t{t}")
                        for t in range(2)]
                r_store = store_eng.serve(reqs)
                r_base = base_eng.serve(reqs)
                assert [r.placement for r in r_store] == ["obs_sharded"] * 2
                for s_, b_ in zip(r_store, r_base):
                    assert s_.error is None
                    _close(s_.coef, b_.coef)
                st = store_eng.store
                assert st.device_used() <= budget
                entry = st.get(f"d{i}")
                assert "obs_sharded" in entry.resident_lanes()
                assert st.device_used() >= 2 * x.nbytes
        assert store_eng.store.stats.demotions_device >= 3
        assert store_eng.store.stats.promotions_host >= 1
        assert store_eng.stats.warm_starts > 0
        store_eng.shutdown()
        base_eng.shutdown()

    def test_over_hbm_requests_reroute_to_stream(self, rng):
        design_bytes = 64 * 32 * 4
        out = []
        for mod, cfg, kw in ((J, J.ServeConfig, {}),
                             (None, ServeConfig, {"device": "cpu"})):
            reg = jobs.MetricsRegistry() if mod else obs.MetricsRegistry()
            Eng = mod.SolverServeEngine if mod else SolverServeEngine
            Req = mod.SolveRequest if mod else SolveRequest
            eng = Eng(cfg(store_device_bytes=design_bytes), registry=reg,
                      **kw)
            x, y, _ = make_system(np.random.default_rng(7), 128, 64)
            req = Req(x=x, y=y, method="bakp", thr=16, max_iter=40,
                      rtol=1e-12, design_key="huge")
            assert eng.spec_for(req, record=True).method == "bakp_stream"
            assert reg.get("solver_fallback_total").value(
                reason="over_hbm") == 1
            [res] = eng.serve([req])
            assert res.error is None
            assert eng.store.stats.builds_nonresident == 1
            # small requests keep their method
            xs, ys, _ = make_system(rng, 32, 16)
            small = Req(x=xs, y=ys, method="bakp", thr=8,
                        design_key="small")
            assert eng.spec_for(small).method == "bakp"
            out.append((res, x, y))
            eng.shutdown()
        (j, x, y), (t, _, _) = out
        assert t.telemetry.kernel_path == "stream_host"
        ref = j_solvebakp(x, y, thr=16, max_iter=40, rtol=1e-12)
        _close(t.coef, np.asarray(ref.coef))
        _close(t.coef, j.coef)

    def test_no_store_config_has_no_store(self):
        eng = SolverServeEngine(ServeConfig(), registry=obs.MetricsRegistry(),
                                device="cpu")
        assert eng.store is None and eng.cache.store is None
        eng.shutdown()

    def test_concurrent_submitters_with_churn(self):
        """Racing submitters through the async dispatcher over more
        designs than the device tier holds: every ticket lands with the
        right answer while designs demote and promote underneath."""
        design_bytes = 64 * 32 * 4
        eng = SolverServeEngine(
            ServeConfig(store_device_bytes=6 * design_bytes,
                        cache_entries=256),
            registry=obs.MetricsRegistry(), device="cpu")
        cfg = DispatchConfig(max_batch=8, idle_timeout_s=0.005,
                             prewarm_cache=True)
        n_sub, per = 4, 10
        systems = {}
        r = np.random.default_rng(77)
        for s in range(n_sub):
            for i in range(per):
                x = r.normal(size=(48, 24)).astype(np.float32)
                a = r.normal(size=(24,)).astype(np.float32)
                systems[(s, i)] = (x, x @ a, a)
        tickets, tlock, errs = {}, threading.Lock(), []

        def submitter(s, disp):
            try:
                for i in range(per):
                    x, y, _ = systems[(s, i)]
                    t = disp.submit(SolveRequest(
                        x=x, y=y, method="bakp", thr=8, max_iter=60,
                        rtol=1e-12, design_key=f"d-{(s + i) % 13}-{i}",
                        request_id=f"q-{s}-{i}"))
                    with tlock:
                        tickets[(s, i)] = t
            except Exception as exc:  # surfaced below
                errs.append(exc)

        with AsyncDispatcher(eng, cfg) as disp:
            threads = [threading.Thread(target=submitter, args=(s, disp))
                       for s in range(n_sub)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            assert not any(t.is_alive() for t in threads)
            assert not errs
            results = {k: t.result(timeout=120.0)
                       for k, t in tickets.items()}
        assert len(results) == n_sub * per
        for (s, i), res in results.items():
            x, y, a = systems[(s, i)]
            assert res.error is None
            # the JAX test's bound: fp32 stall floor of this geometry
            assert _mape(x @ res.coef, y) <= 5e-3
        assert eng.store.stats.demotions_device > 0
        assert len(eng.store) <= 6
        eng.shutdown()
