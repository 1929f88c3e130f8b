#!/usr/bin/env python3
"""Phase split of the Algorithm-1 column step on one GPU.

    python3 tools/bak_phase_split.py                      # the cluster design
    git archive ddd5c3d src/repro_torch/kernels/csrc | tar -x -C old/
    python3 tools/bak_phase_split.py --design grid \
        --csrc old/src/repro_torch/kernels/csrc            # the design before

Times the phases of ``bak_column_step`` with ``clock64`` stamps of thread 0
of CTA 0, summed over every column, at the shapes ``chip_smoke.py`` runs,
and prints per column the time from CUDA events and its split over five
phases.  ``--design cluster`` builds this tree's ``csrc`` with
``-DBAK_PHASE_CLOCKS`` (ring wait and dot, CTA reduction, the push into
the cluster and the mbarrier wait, the cross-cluster exchange, the
rank-order sum and the update).  ``--design grid`` copies the
grid-barrier design's ``csrc`` (commit ddd5c3d), adds the stamps to its
``bak_column.cuh`` by text edits (x_j load and dot, CTA reduction with the
partial's write, ``grid.sync``, the read and sum of the G partials,
update).  Both build ``bak_sweep.cu`` and ``bak_fused.cu`` with ``nvcc``
and call their C entries through ``ctypes``.  The stamps add a few percent
to a step.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

PHASES = {"grid": ["dot", "cta_reduce_write", "grid_sync",
                    "partials_read_sum", "update"],
          "cluster": ["ring_wait_dot", "cta_reduce", "push_wait",
                      "cross_cluster", "sum_update"]}
REGIMES = ("single_cluster", "multi_cluster", "e_device")
CASES = [("bak_sweep", 256, 16384, 1), ("bak_sweep", 256, 16384, 8),
         ("bak_sweep", 1024, 262144, 8), ("bak_fused", 256, 16384, 1),
         ("bak_fused", 256, 16384, 8)]
FUSED_SWEEPS = 20
MIN_OBS_PER_CTA = 128

# Text edits of the grid-barrier header: (anchor, replacement), each anchor
# found exactly once.
_EDITS = [
    ('#include "bakp_block.cuh"\n',
     '#include "bakp_block.cuh"\n'
     "__device__ unsigned long long g_phase[6];\n"
     "#define STAMP(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { "
     "long long _t = clock64(); atomicAdd(&g_phase[i], "
     "(unsigned long long)(_t - _t0)); _t0 = _t; } } while (0)\n"),
    ("  const float* xrow = xj + c.s.o0;\n",
     "  const float* xrow = xj + c.s.o0;\n  long long _t0 = clock64();\n"),
    ("    bak_block_sum<KC>(acc, kc, s_red, c.s_g + r0);\n"
     "    if ((int)threadIdx.x < kc)\n"
     "      part[(size_t)blockIdx.x * k + r0 + threadIdx.x] = "
     "c.s_g[r0 + threadIdx.x];\n  }\n  grid.sync();\n",
     "    STAMP(0);\n"
     "    bak_block_sum<KC>(acc, kc, s_red, c.s_g + r0);\n"
     "    if ((int)threadIdx.x < kc)\n"
     "      part[(size_t)blockIdx.x * k + r0 + threadIdx.x] = "
     "c.s_g[r0 + threadIdx.x];\n    STAMP(1);\n  }\n  grid.sync();\n"
     "  STAMP(2);\n"),
    ("    bak_block_sum<KC>(acc, kc, s_red, c.s_g + r0);\n  }\n\n  // 3.",
     "    bak_block_sum<KC>(acc, kc, s_red, c.s_g + r0);\n  }\n  STAMP(3);\n"
     "\n  // 3."),
    ("      *ep = fmaf(-(c.s_g[r] * inv_j), xv, *ep);\n    }\n  }\n}\n",
     "      *ep = fmaf(-(c.s_g[r] * inv_j), xv, *ep);\n    }\n  }\n"
     "  STAMP(4);\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_phase[5], 1ull);\n"
     "}\n"
     'extern "C" int bak_timing_read(unsigned long long* out) {\n'
     "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n"
     'extern "C" int bak_timing_reset() {\n'
     "  unsigned long long z[6] = {0, 0, 0, 0, 0, 0};\n"
     "  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n}\n"),
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {"grid": {
    "bak_sweep": {"bak_sweep_grid": [_I, _I, _I, _P, _P],
                  "bak_sweep_launch": [_P] * 6 + [_I] * 5 + [_P]},
    "bak_fused": {"bak_fused_grid": [_I, _I, _I, _P, _P],
                  "bak_fused_launch": [_P] * 12 + [_I] * 4 + [_F] * 2
                  + [_I] * 2 + [_P]}},
    "cluster": {
    "bak_sweep": {"bak_sweep_grid": [_I] * 5 + [_P],
                  "bak_sweep_launch": [_P, _I] + [_P] * 5 + [_I] * 6 + [_P]},
    "bak_fused": {"bak_fused_grid": [_I] * 5 + [_P],
                  "bak_fused_launch": [_P, _I] + [_P] * 10 + [_I] * 4
                  + [_F] * 2 + [_I] * 3 + [_P]}}}


def instrument(csrc: Path, work: Path) -> Path:
    """Copy the grid-barrier ``csrc`` to ``work/csrc`` with the stamps
    added; returns it."""
    dst = work / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    hdr = dst / "bak_column.cuh"
    text = hdr.read_text()
    for anchor, repl in _EDITS:
        if text.count(anchor) != 1:
            raise SystemExit(f"{hdr}: not the grid-barrier header (anchor "
                             f"{anchor[:40]!r} found {text.count(anchor)} times)")
        text = text.replace(anchor, repl)
    hdr.write_text(text)
    return dst


def build(src: Path, work: Path, name: str, design: str) -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = work / f"lib{name}-{design}.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-DBAK_PHASE_CLOCKS", "-o", str(out),
                    str(src / f"{name}.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, args in _SIGS[design][name].items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    return lib


def read_clocks(lib, design: str):
    """The six clock counters (five phases, then the step count)."""
    buf = (ctypes.c_ulonglong * 6)()
    if design == "grid":
        lib.bak_timing_read.argtypes = [_P]
        lib.bak_timing_read(ctypes.addressof(buf))
    else:
        lib.bak_phase_clocks.argtypes = [_P, _I]
        lib.bak_phase_clocks(ctypes.addressof(buf), 0)
    return list(buf)


def reset_clocks(lib, design: str) -> None:
    if design == "grid":
        lib.bak_timing_reset()
    else:
        lib.bak_phase_clocks.argtypes = [_P, _I]
        lib.bak_phase_clocks(None, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--design", choices=("cluster", "grid"), default="cluster")
    ap.add_argument("--csrc", type=Path,
                    default=Path(__file__).resolve().parents[1]
                    / "src/repro_torch/kernels/csrc",
                    help="csrc directory of the design")
    ap.add_argument("--cluster", type=int, default=16,
                    help="cluster size (--design cluster)")
    ap.add_argument("--work", type=Path,
                    default=Path(__file__).resolve().parents[1]
                    / "src/repro_torch/kernels/build/phase_split",
                    help="build and output directory (git-ignored by default)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bak_phase_split: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    args.work.mkdir(parents=True, exist_ok=True)
    design = args.design
    src = instrument(args.csrc, args.work) if design == "grid" else args.csrc
    libs = {n: build(src, args.work, n, design) for n in _SIGS[design]}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, nv, no, k in CASES:
        lib = libs[name]
        x_t = torch.randn(nv, no, generator=gen, device="cuda")
        inv = 1.0 / (x_t * x_t).sum(1)
        e = torch.randn(k, no, generator=gen, device="cuda")
        f32 = dict(dtype=torch.float32, device="cuda")
        out_e = torch.empty_like(e)
        plan_fn = getattr(lib, f"{name}_grid")
        if design == "grid":
            grid, e_smem = _I(0), _I(0)
            if plan_fn(no, k, MIN_OBS_PER_CTA, ctypes.addressof(grid),
                       ctypes.addressof(e_smem)):
                raise RuntimeError(f"{name}_grid failed")
            plan = {"ctas": grid.value, "e_smem": e_smem.value}
            partials = torch.empty((2, grid.value, k), **f32)
            tail = [grid.value, e_smem.value, stream]
        else:
            out = (_I * 6)()
            if plan_fn(no, k, MIN_OBS_PER_CTA, args.cluster, 4,
                       ctypes.addressof(out)):
                raise RuntimeError(f"{name}_grid failed")
            plan = {"regime": REGIMES[out[0]], "ctas": out[1],
                    "cluster": out[2], "clusters": out[3]}
            xchg = torch.zeros((max(out[5], 1),), dtype=torch.int32,
                               device="cuda")
            tail = [out[0], out[1], out[2], stream]
        if name == "bak_sweep":
            da = torch.empty((nv, k), **f32)
            ptrs = [x_t.data_ptr(), inv.data_ptr(), e.data_ptr(),
                    out_e.data_ptr(), da.data_ptr()]

            def launch():
                if design == "grid":
                    return lib.bak_sweep_launch(*ptrs, partials.data_ptr(),
                                                nv, no, k, *tail)
                xchg.zero_()
                return lib.bak_sweep_launch(ptrs[0], 4, *ptrs[1:],
                                            xchg.data_ptr(), nv, no, k, *tail)
        else:
            a0 = torch.zeros((nv, k), **f32)
            coef = torch.empty((nv, k), **f32)
            hist = torch.empty((FUSED_SWEEPS,), **f32)
            sse = torch.empty((1,), **f32)
            n_out = torch.empty((1,), dtype=torch.int32, device="cuda")
            conv = torch.empty((1,), dtype=torch.int32, device="cuda")
            ptrs = [x_t.data_ptr(), inv.data_ptr(), e.data_ptr(),
                    a0.data_ptr(), coef.data_ptr(), out_e.data_ptr(),
                    hist.data_ptr(), sse.data_ptr(), n_out.data_ptr(),
                    conv.data_ptr()]

            sse_part = torch.empty((plan["ctas"],), **f32)

            def launch():
                if design == "grid":
                    return lib.bak_fused_launch(
                        *ptrs, partials.data_ptr(), sse_part.data_ptr(), nv,
                        no, k, FUSED_SWEEPS, 0.0, 0.0, *tail)
                xchg.zero_()
                return lib.bak_fused_launch(
                    ptrs[0], 4, *ptrs[1:], xchg.data_ptr(), nv, no, k,
                    FUSED_SWEEPS, 0.0, 0.0, *tail)
        for _ in range(2):
            if launch():
                raise RuntimeError(f"{name} launch failed")
        torch.cuda.synchronize()
        iters = 5 if no > 100_000 else 20
        reset_clocks(lib, design)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            launch()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        buf = read_clocks(lib, design)
        cyc = [buf[i] / buf[5] for i in range(5)]
        us_col = ms * 1e3 / (buf[5] / iters)
        row = {"design": design, "kernel": name, "vars": nv, "obs": no,
               "k": k, "plan": plan, "ms": ms, "us_per_column": us_col,
               "split_us": {p: c / sum(cyc) * us_col
                            for p, c in zip(PHASES[design], cyc)}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    (args.work / f"split-{design}.json").write_text(json.dumps(
        {"device": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
