"""BENCHMARK.json against the contract, resolved by name."""
import copy
import json

import pytest

from sbtest import BENCH_DIR, ROOT, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["solverbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.resolve_cell(cell)
    assert c.chips == 1
    assert "setup_s" in [m.name for m in c.end_to_end]
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m.name))
    assert callable(spec.work_counter(c.traffic["method"]))
    assert hasattr(spec.reference(c.config["reference"]), "solve")


def test_check_all_and_entry_keys():
    cells = spec.check_all()
    assert list(cells) == ["tall.shared", "tall.solo", "tall1e4.shared"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("solverbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]


@pytest.mark.parametrize("key,drop", [("configs", "why"),
                                      ("configs", "reduced"),
                                      ("workloads", "why")])
def test_entry_without_a_key_refused(key, drop):
    bench = copy.deepcopy(BENCH)
    del bench[key][0][drop]
    with pytest.raises(spec.SpecError):
        spec.check_all(bench)


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "µs", "", "-x",
                                 "x" * 65])
def test_bad_names_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_name(bad, "metric")
    bench = copy.deepcopy(BENCH)
    bench["per_layer"][0]["name"] = bad
    with pytest.raises(spec.SpecError):
        spec.metrics_of(bench)


@pytest.mark.parametrize("bad", ["tokens per second", "µs", "", "x" * 17,
                                 "a,b"])
def test_bad_units_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_unit(bad, "m")
    bench = copy.deepcopy(BENCH)
    bench["end_to_end"][0]["unit"] = bad
    with pytest.raises(spec.SpecError):
        spec.metrics_of(bench)


@pytest.mark.parametrize("good", ["rhs/s", "%", "ms", "sweeps", "tokens/s"])
def test_good_units_pass(good):
    assert spec.check_unit(good, "m") == good


def test_unknown_workload_refused():
    with pytest.raises(spec.SpecError):
        spec.resolve_cell("p9.nothing")


def test_files_named_from_name_characters():
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert all(ch.isascii() and (ch.isalnum() or ch in "_.-/")
                   for ch in rel), rel
