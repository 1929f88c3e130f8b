"""A configuration's design module (``designs/<name>.py``), its own checks,
and a traffic's solver settings (``"spec"``).

The planted cells draw bit for bit what they drew before designs were
modules, and build the same ``SolverSpec``.  A design module kept beside
these tests (``shared_direction.py``: columns that share one direction,
as a language model's features do), found by pointing ``spec.DESIGN_DIR``
here, drives whole CPU runs with its own check and a traffic that states
omega.  Wrong names and keys fail in ``spec.check_all`` before any run."""
import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from sbtest import BENCH_DIR, ROOT, run_tiny, spec, tiny_cell

TESTS_DIR = BENCH_DIR / "tests"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
OMEGA = 0.5


def _parent_make_designs(config, traffic, seed, device):
    """``harness.inputs.make_designs`` as it was before designs were
    modules: (key, x, y_pool) of each design."""
    obs, nvars = int(config["obs"]), int(config["vars"])
    pool = int(traffic["rhs_pool"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 64)
    out = []
    for d in range(int(traffic["designs"])):
        x = torch.randn((obs, nvars), generator=g, device=device,
                        dtype=torch.float32)
        a = torch.randn((nvars, pool), generator=g, device=device,
                        dtype=torch.float32)
        y = (x @ a).T.contiguous().cpu().numpy()
        out.append((f"sb{d}-{int(seed) % 2 ** 64:x}", x, y))
    return out


def _parent_solver_spec(traffic, precision):
    """The ``SolverSpec`` ``run_cell`` built before a traffic could add
    settings."""
    from repro_torch.core.spec import SolverSpec
    return SolverSpec(method=traffic["method"],
                      max_iter=int(traffic["max_iter"]),
                      rtol=float(traffic["rtol"]), thr=int(traffic["thr"]),
                      precision=precision)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11, 2 ** 40 + 3])
def test_planted_designs_bit_for_bit_the_parents(seed):
    from harness.inputs import make_designs
    c = tiny_cell()     # 6,000 x 100, 2 designs, a pool of 16
    got = make_designs(c.config, c.traffic, seed, "cpu")
    want = _parent_make_designs(c.config, c.traffic, seed, "cpu")
    assert len(got) == len(want) == 2
    for d, (key, x, y) in zip(got, want):
        assert d.key == key
        assert torch.equal(d.x, x)
        assert np.array_equal(d.y_pool, y)


@pytest.mark.parametrize("mix", ["shared16", "solo4"])
def test_existing_mixes_build_the_parents_spec(mix):
    traffic = json.loads((spec.TRAFFIC_DIR / f"{mix}.json").read_text())
    assert "spec" not in traffic
    for precision in ("fp32", "bf16"):
        assert (spec.solver_spec(traffic, precision)
                == _parent_solver_spec(traffic, precision))


@pytest.fixture
def fixture_designs(monkeypatch):
    monkeypatch.setattr(spec, "DESIGN_DIR", TESTS_DIR)


def probe_cell(feature_limit=1e-5, omega=OMEGA):
    """The tiny cell on the fixture design, its traffic stating omega."""
    c = tiny_cell()
    config = dict(c.config, design="shared_direction", shared=0.15,
                  mix=0.125, check={"coef_err": c.config["check"]["coef_err"],
                                    "feature_err": feature_limit})
    traffic = dict(c.traffic, spec={"omega": omega})
    return dataclasses.replace(c, config=config, traffic=traffic)


def test_fixture_design_run_is_correct(fixture_designs):
    out = run_tiny(probe_cell(), seed=2 ** 33 + 21)
    assert out.result["correct"], out.checks
    feature = out.result["checks"]["feature_err"]
    assert feature["limit"] == 1e-5
    assert 0 < feature["value"] <= 1e-5
    assert out.readings["feature_err"] == feature["value"]
    assert any(line.startswith("check feature_err") for line in out.checks)
    assert list(out.result)[-1] == "checks"


def test_fixture_check_over_its_limit_is_not_correct(fixture_designs):
    out = run_tiny(probe_cell(feature_limit=1e-9), seed=2 ** 33 + 21)
    assert out.readings["feature_err"] > 1e-9
    coef = out.result["checks"]["coef_err"]
    assert coef["value"] <= coef["limit"]
    assert out.result["failed"] == 0
    assert not out.result["correct"]


def test_requests_carry_the_traffic_omega(fixture_designs):
    from repro_torch.core import spec as core_spec
    real = core_spec.solver_method("bakp_stream")
    seen = []

    def solve(p, y, solver, **kw):
        seen.append(solver.omega)
        return real.solve(p, y, solver, **kw)

    core_spec.register_method(dataclasses.replace(real, solve=solve),
                              overwrite=True)
    try:
        out = run_tiny(probe_cell(), seed=22)
    finally:
        core_spec.register_method(real, overwrite=True)
    assert out.result["correct"], out.checks
    assert seen and set(seen) == {OMEGA}


def test_fixture_at_omega_one_is_not_correct(fixture_designs):
    # The shared direction is why the traffic states omega: Algorithm 2's
    # block update at omega 1 overshoots along it.
    out = run_tiny(probe_cell(omega=1.0), seed=23)
    assert not out.result["correct"]
    limit = out.result["checks"]["coef_err"]["limit"]
    assert out.readings["coef_err"] > 10 * limit


# --------------------------------------------- refused before any run

def _bench_with(tmp_path, monkeypatch, *, config=None, spec_=None):
    """BENCHMARK.json with one more cell: the first configuration's file
    changed by ``config`` and the shared16 mix with ``spec_`` as its
    "spec", both written under ``tmp_path``, where the design modules are
    the benchmark's and the fixture's."""
    design_dir, traffic_dir = tmp_path / "designs", tmp_path / "traffic"
    for to, files in ((design_dir, [*(BENCH_DIR / "designs").glob("*.py"),
                                    TESTS_DIR / "shared_direction.py"]),
                      (traffic_dir, (BENCH_DIR / "traffic").glob("*.json"))):
        to.mkdir()
        for p in files:
            (to / p.name).write_text(p.read_text())
    monkeypatch.setattr(spec, "DESIGN_DIR", design_dir)
    monkeypatch.setattr(spec, "TRAFFIC_DIR", traffic_dir)
    base = BENCH["configs"][0]
    cfg = json.loads((ROOT / base["file"]).read_text())
    cfg.update(config or {})
    (tmp_path / "probe.json").write_text(json.dumps(cfg))
    mix = json.loads((traffic_dir / "shared16.json").read_text())
    if spec_ is not None:
        mix["spec"] = spec_
    (traffic_dir / "probe16.json").write_text(json.dumps(mix))
    bench = copy.deepcopy(BENCH)
    bench["configs"].append(dict(base, name="probe_cfg",
                                 file=str(tmp_path / "probe.json")))
    bench["workloads"].append(dict(bench["workloads"][0], name="probe.cell",
                                   config="probe_cfg", traffic="probe16"))
    return bench


FIXTURE = {"design": "shared_direction", "shared": 0.15, "mix": 0.125,
           "check": {"coef_err": 2e-6, "feature_err": 1e-5}}


def test_fixture_cell_passes_check_all(tmp_path, monkeypatch):
    bench = _bench_with(tmp_path, monkeypatch, config=FIXTURE,
                        spec_={"omega": OMEGA})
    cells = spec.check_all(bench)
    assert list(cells)[-1] == "probe.cell"
    solver = spec.solver_spec(cells["probe.cell"].traffic, "fp32")
    assert solver.omega == OMEGA


@pytest.mark.parametrize("config", [
    {"design": "no_such_design"},
    {"design": "has space"},
    {"check": {"coef_err": 2e-6, "residual_err": 1e-3}},
    dict(FIXTURE, check={"coef_err": 2e-6, "feature_err": 1e-5,
                         "logit_gap": 1.0}),
    dict(FIXTURE, check={"coef_err": 2e-6}),
    {"check": {"feature_err": 1e-5}},
], ids=["missing-design", "bad-design-name", "unknown-check",
        "unknown-check-beside-design", "design-check-without-limit",
        "harness-check-without-limit"])
def test_config_refused_before_any_run(tmp_path, monkeypatch, config):
    bench = _bench_with(tmp_path, monkeypatch, config=config)
    with pytest.raises(spec.SpecError):
        spec.check_all(bench)


@pytest.mark.parametrize("spec_", [
    {"ridge": 0.1},             # changes the problem the reference solves
    {"omega": 0.5, "max_iter": 5},
    {"precision": "bf16"},
    {"method": "bak"},
    {"atol": 0.0},              # no cell needs it
    {"omega": 0.5, "refine_sweeps": 2},     # inert outside bf16_fp32acc
    ["omega"],
], ids=["ridge", "max_iter", "precision", "method", "atol", "refine_sweeps",
        "not-an-object"])
def test_traffic_spec_key_refused(tmp_path, monkeypatch, spec_):
    bench = _bench_with(tmp_path, monkeypatch, spec_=spec_)
    with pytest.raises(spec.SpecError):
        spec.check_all(bench)


@pytest.mark.parametrize("spec_", [
    {"omega": "fast"}, {"omega": None}, {"omega": {"value": 0.5}},
    {"omega": [0.5]},
], ids=["omega-word", "omega-null", "omega-object", "omega-list"])
def test_traffic_spec_value_refused(tmp_path, monkeypatch, spec_):
    bench = _bench_with(tmp_path, monkeypatch, spec_=spec_)
    with pytest.raises(spec.SpecError):
        spec.check_all(bench)
