"""The harness never loads JAX or the JAX package, and never falls back to
the CPU."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from sbtest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH_DIR).as_posix() for p in BENCH_DIR.rglob("*.py")
    if "__pycache__" not in p.parts))
def test_no_source_imports_jax(path):
    names = set(_top_level_imports(BENCH_DIR / path))
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_nothing_reads_benchmarks_folder():
    for p in BENCH_DIR.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        assert "benchmarks/" not in p.read_text(), p


def test_run_imports_no_jax():
    # Import everything run.py and a run import (readers, work counters,
    # the reference, the program's serving stack) in a fresh process and
    # compare top-level module names whole: repro_torch is not repro.
    code = (
        "import sys; sys.argv=['run.py']; sys.path.insert(0, %r)\n"
        "import run\n"
        "from harness import spec, cell, load, devtrace, inputs\n"
        "cells = spec.check_all()\n"
        "for c in cells.values():\n"
        "    [spec.metric_reader(m.name) for m in c.end_to_end + c.per_layer]\n"
        "import repro_torch.serve, repro_torch.core\n"
        "print('FOUND', run.forbidden_modules())\n") % str(BENCH_DIR)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_forbidden_compares_whole_names():
    sys.path.insert(0, str(BENCH_DIR))
    import run
    assert run.forbidden_modules({"repro_torch", "repro_torch.serve",
                                  "reprox", "jax_like"}) == []
    assert run.forbidden_modules({"repro.core", "jaxlib.xla"}) == [
        "jaxlib", "repro"]


def _run_cli(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "solverbench/run.py", "--workload", "tall.shared",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_no_card_fails_without_result():
    out = _run_cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not _printed_result(out.stdout)
    assert "no CUDA device" in out.stderr


def test_bare_benchmark_directory_fails(tmp_path):
    # Only BENCHMARK.json and the benchmark's own files: no program.
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "solverbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(tmp_path, {})
    assert out.returncode != 0
    assert not _printed_result(out.stdout)
