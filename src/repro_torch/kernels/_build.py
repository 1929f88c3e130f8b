"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes``.  Nothing is built at
import: the first call that needs a kernel builds it, or ``build_all()``
builds every source at once, one ``nvcc`` process per source, all started
together.  Libraries land in ``kernels/build/`` (git-ignored) under a name
carrying a hash of the flags, the library's ``.cu`` and the ``csrc``
headers it includes (followed transitively), so editing a source rebuilds
exactly the libraries that compile it and the rest load as they are.

Launch counts also live here: every wrapper adds one to
``LAUNCHES[launch_key(name, itemsize)]`` where it launches its kernel, and
nowhere else; the five kernels that read x count their launches on a bf16
x apart (``"<name>_bf16"``).  A kernel whose launch plan varies with the
shape (the cluster kernels' regimes) records the plan of its last launch
under the same key in ``PLANS``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launch count per kernel name (the ``csrc`` file stem).
LAUNCHES: Counter = Counter()
# Plan of the last launch per kernel name, where the plan varies.
PLANS: Dict[str, tuple] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# C signatures of every entry point, by library.  The kernels that read x
# take it untyped, followed by its element size in bytes (4 fp32, 2 bf16).
SIGNATURES: Dict[str, Dict[str, list]] = {
    "bakp_sweep": {
        "bakp_sweep_clusters": [_I, _I, _I, _P],
        "bakp_sweep_launch": [_P, _I] + [_P] * 5 + [_U] + [_I] * 4 + [_F]
        + [_I] * 6 + [_P],
    },
    "fused_solve": {
        "bakp_fused_clusters": [_I, _I, _I, _P],
        "bakp_fused_launch": [_P, _I] + [_P] * 10 + [_U] + [_I] * 6
        + [_F] * 3 + [_I] * 5 + [_P],
    },
    "bak_sweep": {
        "bak_sweep_grid": [_I] * 5 + [_P],
        "bak_sweep_launch": [_P, _I] + [_P] * 5 + [_I] * 6 + [_P],
    },
    "bak_fused": {
        "bak_fused_grid": [_I] * 5 + [_P],
        "bak_fused_launch": [_P, _I] + [_P] * 10 + [_I] * 4 + [_F] * 2
        + [_I] * 3 + [_P],
    },
    "score_features": {
        "score_features_launch": [_P] * 5 + [_I] * 4 + [_P],
    },
    "block_update": {
        "block_update_launch": [_P] * 4 + [_I] * 3 + [_P],
    },
    "stream_solve": {
        "stream_solve_clusters": [_I, _I, _I, _P],
        "stream_solve_launch": [_P, _I] + [_P] * 10 + [_U] + [_I] * 5
        + [_F] * 3 + [_I] * 4 + [_P],
    },
}
# The kernels that read x, in fp32 or bf16.
X_KERNELS = ("bakp_sweep", "fused_solve", "bak_sweep", "bak_fused",
             "stream_solve")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def launch_key(name: str, itemsize: int = 4) -> str:
    """The key of ``LAUNCHES`` / ``PLANS`` for kernel ``name`` on an x of
    ``itemsize`` bytes an element: ``name`` for fp32, ``name + "_bf16"``."""
    if itemsize not in (2, 4):
        raise ValueError(f"x of {itemsize} bytes an element")
    return name if itemsize == 4 else name + "_bf16"


def launch_counts(itemsize: int = 4) -> Dict[str, int]:
    """Launches per kernel on an x of ``itemsize`` bytes an element, by
    ``launch_key``: every kernel for fp32, the x-reading ones for bf16."""
    names = SIGNATURES if itemsize == 4 else X_KERNELS
    return {launch_key(n, itemsize): LAUNCHES[launch_key(n, itemsize)]
            for n in names}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly or
    through another header, in a fixed order."""
    seen, todo = {}, [CSRC / f"{name}.cu"]
    while todo:
        src = todo.pop()
        if src.name in seen or not src.exists():
            continue
        seen[src.name] = src
        todo.extend(CSRC / inc.decode() for inc in _INCLUDE.findall(src.read_bytes()))
    return [seen[n] for n in sorted(seen)]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> subprocess.Popen:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every (or the named) missing library in parallel; returns the
    compiler's output (``-Xptxas -v`` register and shared-memory report) per
    library built.  Raises ``RuntimeError`` if any build fails."""
    names = list(SIGNATURES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock:
        procs = {n: _start(n) for n in names if not _lib_path(n).exists()}
        logs, failed = {}, []
        for n, proc in procs.items():
            logs[n] = proc.communicate()[0]
            tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            if proc.returncode != 0:
                failed.append(n)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _lib_path(n))
                (BUILD_DIR / f"{n}.log").write_text(logs[n])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {err}")
