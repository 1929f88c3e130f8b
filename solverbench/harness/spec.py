"""``BENCHMARK.json`` read, checked and resolved by name.

Everything that belongs to one configuration, traffic mix, metric or
method sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

  configs/<file named by the configuration's "file">   sizes and limits
  traffic/<traffic>.json                              one mix's parameters
  metrics/<metric>.py                                 ``read(run)``
  work/<method>.py                                    ``solve_work(...)``
  reference/<reference>.py                            the plain reference
  designs/<design>.py                                 ``draw``, ``check``

so a later change adds a cell, a mix or a metric as new files and
entries, and edits none that is there.

A configuration names its design module under ``"design"`` (without it,
``planted_normal``, the paper's x ~ N(0, 1)).  The module's
``draw(config, generator, device)`` returns one design's x, (obs, vars)
fp32 on ``device``, drawn from ``generator`` alone.  Its optional
``check(config, designs, device)`` runs after the window with the
program freed and returns one number for each name in its ``CHECKS``;
each ``inputs.Design`` carries its ``x`` and ``state``, the generator's
state where its draw began, so the check can draw the same weights and
tokens again.  The
configuration's ``"check"`` gives a limit for each of those names and for
the harness's own ``coef_err``, and a run is correct only where every
number is within its limit.  A traffic mix may add ``"spec"``: solver
settings from ``SPEC_KEYS`` that every request carries.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
TRAFFIC_DIR = BENCH_DIR / "traffic"
DESIGN_DIR = BENCH_DIR / "designs"

DEFAULT_DESIGN = "planted_normal"
#: The numbers the harness itself compares, each with a limit in the
#: configuration's "check" (``failed`` has the limit 0 and none there).
HARNESS_CHECKS = ("coef_err",)
#: ``SolverSpec`` fields a traffic's "spec" may set: those that leave the
#: least-squares problem the reference solves unchanged (not ``ridge``)
#: and that a cell needs.  Block updates on features that share a
#: direction overshoot at omega 1.
SPEC_KEYS = ("omega",)

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
}


class SpecError(ValueError):
    """``BENCHMARK.json`` or a file it names breaks the contract."""


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.fullmatch(name):
        raise SpecError(f"{what} {name!r}: a name is 1 to 64 of A-Z a-z "
                        f"0-9 _ . - and starts with a letter, digit or _")
    return name


def check_unit(unit, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.fullmatch(unit):
        raise SpecError(f"{what} unit {unit!r}: 1 to 16 of A-Z a-z 0-9 "
                        f"_ / % . -")
    return unit


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    moves: Optional[str]
    workloads: Optional[tuple]


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict            # the configuration file's contents
    traffic: dict           # the mix's parameters
    chips: int
    end_to_end: tuple       # Metric entries this cell reports, trace 0
    per_layer: tuple        # Metric entries this cell reports, trace 1


def _load_module(path: Path, prefix: str):
    if not path.is_file():
        shown = path.relative_to(ROOT) if path.is_relative_to(ROOT) else path
        raise SpecError(f"missing {shown}")
    mod_name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    return _load_module(BENCH_DIR / "metrics" / f"{check_name(name, 'metric')}.py",
                        "sb_metric_").read


def work_counter(method: str):
    """``solve_work(obs, nvars, k, sweeps, itemsize) -> (bytes, flops)`` of
    ``work/<method>.py``: the least work a solve of ``method`` needs."""
    return _load_module(BENCH_DIR / "work" / f"{check_name(method, 'method')}.py",
                        "sb_work_").solve_work


def reference(name: str):
    """The plain reference module ``reference/<name>.py``."""
    return _load_module(BENCH_DIR / "reference" / f"{check_name(name, 'reference')}.py",
                        "sb_ref_")


def design(name: str):
    """The design module ``designs/<name>.py`` (under ``DESIGN_DIR``)."""
    mod = _load_module(DESIGN_DIR / f"{check_name(name, 'design')}.py",
                       "sb_design_")
    if not callable(getattr(mod, "draw", None)):
        raise SpecError(f"design {name}: has no draw(config, generator, "
                        f"device)")
    if callable(getattr(mod, "check", None)) != hasattr(mod, "CHECKS"):
        raise SpecError(f"design {name}: a check(...) and its CHECKS come "
                        f"together")
    return mod


def design_of(config: dict):
    """The design module a configuration names."""
    return design(config.get("design", DEFAULT_DESIGN))


def check_limits(config: dict) -> None:
    """The configuration's "check" holds a limit for each number the
    harness and its design compute, and for nothing else."""
    want = set(HARNESS_CHECKS) | set(getattr(design_of(config), "CHECKS", ()))
    have = set(config.get("check", {}))
    if have != want:
        raise SpecError(f"config {config.get('name')!r}: check has "
                        f"{sorted(have)}; the harness and its design compute "
                        f"{sorted(want)} (unknown {sorted(have - want)}, "
                        f"no limit {sorted(want - have)})")


def solver_spec(traffic: dict, precision: str):
    """The ``SolverSpec`` every request of the mix carries: its ``method``,
    ``max_iter``, ``rtol`` and ``thr``, the configuration's precision, and
    the mix's "spec" settings."""
    from repro_torch.core import SolverSpec
    extra = traffic.get("spec", {})
    if not isinstance(extra, dict) or set(extra) - set(SPEC_KEYS):
        raise SpecError(f"traffic spec {extra!r}: an object with keys from "
                        f"{list(SPEC_KEYS)}")
    try:
        return SolverSpec(method=traffic["method"],
                          max_iter=int(traffic["max_iter"]),
                          rtol=float(traffic["rtol"]), thr=int(traffic["thr"]),
                          precision=precision, **extra)
    except (TypeError, ValueError) as exc:
        raise SpecError(f"traffic spec {extra!r}: {exc}") from exc


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of the device named ``kind``, or None."""
    table = json.loads((BENCH_DIR / "peaks.json").read_text())
    return table.get(kind)


def _metric(entry: dict, e2e: bool) -> Metric:
    name = check_name(entry.get("name"), "metric")
    check_unit(entry.get("unit"), name)
    if entry.get("better") not in ("lower", "higher"):
        raise SpecError(f"metric {name}: better is lower or higher")
    wl = entry.get("workloads")
    return Metric(name=name, unit=entry["unit"], better=entry["better"],
                  source=entry.get("source", ""), end_to_end=e2e,
                  moves=None if e2e else entry.get("moves"),
                  workloads=None if wl is None else tuple(wl))


def load_benchmark(path: Optional[Path] = None) -> dict:
    path = path or ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no {path.name} beside {BENCH_DIR.name}/")
    return json.loads(path.read_text())


def metrics_of(bench: dict) -> List[Metric]:
    out = [_metric(m, True) for m in bench.get("end_to_end", [])]
    out += [_metric(m, False) for m in bench.get("per_layer", [])]
    seen = set()
    for m in out:
        if m.name in seen:
            raise SpecError(f"metric {m.name} named twice")
        seen.add(m.name)
    return out


def _reports(metric: Metric, cell: str, e2e_of_cell: List[str]) -> bool:
    if metric.workloads is not None:
        return cell in metric.workloads
    if metric.end_to_end:
        return True
    return metric.moves in e2e_of_cell


def resolve_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = bench if bench is not None else load_benchmark()
    check_name(name, "workload")
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench.get("configs", [])}
    cfg_entry = configs.get(check_name(w.get("config"), "config"))
    if cfg_entry is None:
        raise SpecError(f"workload {name}: no config {w.get('config')!r}")
    cfg_path = ROOT / cfg_entry["file"]
    if not cfg_path.is_file():
        raise SpecError(f"config file {cfg_entry['file']} is missing")
    config = json.loads(cfg_path.read_text())
    traffic_path = TRAFFIC_DIR / f"{check_name(w.get('traffic'), 'traffic')}.json"
    if not traffic_path.is_file():
        raise SpecError(f"traffic file {traffic_path.relative_to(ROOT)} is missing")
    traffic = json.loads(traffic_path.read_text())
    metrics = metrics_of(bench)
    e2e = [m for m in metrics if m.end_to_end and _reports(m, name, [])]
    e2e_names = [m.name for m in e2e]
    layer = [m for m in metrics
             if not m.end_to_end and _reports(m, name, e2e_names)]
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w.get("chips", 1)), end_to_end=tuple(e2e),
                per_layer=tuple(layer))


def check_all(bench: Optional[dict] = None) -> Dict[str, Cell]:
    """Resolve every cell, and load every reader, work counter, reference
    and design the cells need, with the limits and solver settings they
    state: what a run would fail on, found without a run."""
    bench = bench if bench is not None else load_benchmark()
    for key in ("configs", "workloads"):
        for entry in bench.get(key, []):
            check_name(entry.get("name"), key[:-1])
            if set(entry) != ENTRY_KEYS[key]:
                raise SpecError(f"{key[:-1]} {entry.get('name')!r}: keys are "
                                f"exactly {sorted(ENTRY_KEYS[key])}")
            why = entry["why"]
            if not (1 <= len(why) <= 200) or "\n" in why or "\t" in why:
                raise SpecError(f"{key[:-1]} {entry['name']}: why is 1 to "
                                f"200 characters on one line, with no tab")
    out = {}
    for w in bench.get("workloads", []):
        cell = resolve_cell(w["name"], bench)
        for m in cell.end_to_end + cell.per_layer:
            metric_reader(m.name)
        work_counter(cell.traffic["method"])
        reference(cell.config["reference"])
        check_limits(cell.config)
        solver_spec(cell.traffic, cell.config["precision"])
        out[cell.name] = cell
    return out
