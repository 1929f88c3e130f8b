#!/usr/bin/env python3
"""Phase split of the Algorithm-2 block step on one GPU.

    python3 tools/bakp_phase_split.py                      # the cluster design
    mkdir -p old && git archive 4d81b73 src/repro_torch/kernels/csrc | tar -x -C old
    python3 tools/bakp_phase_split.py --design grid \
        --csrc old/src/repro_torch/kernels/csrc            # the design before

Times the phases of one column-block step of ``stream_solve``,
``bakp_sweep`` and ``fused_solve`` with ``clock64`` stamps of thread 0 of
CTA 0, summed over every step, at the shapes ``chip_smoke.py`` runs (phase
3: 4,096 x 16,384 at thr 128, k 1 and 8, 20 fixed sweeps; the sweep at
phase 1, 256 x 16,384 at thr 128, k 1 and 8, at phase 2, 1,024 x 262,144
at thr 256, k 8, and at phase 3, k 8; the fused solve at phase 1, k 1 and
8, and on a 512 x 16,384 design at k 8, 20 fixed sweeps), and prints per
step the time
from CUDA events and its split over the phases, scaled so that they add up
to it.  The stamps slow a step (a clock read ends each column group of the
partials), so the split is a share of a stamped step; ``--no-clocks``
gives the times without them.

``--design grid`` copies the grid-barrier design's ``csrc`` (commit
4d81b73), adds the stamps to its ``bakp_block.cuh`` and ``stream_solve.cu``
by text edits and calls the C entries through ``ctypes`` (the streaming
solve and the sweep; ``tools/stop_witness.py`` also builds that design's
whole-solve kernel, unstamped).  Phases: ring
wait (the tile fetch's issue and wait; stream only), the partials' FMAs,
their cross-lane sums and write, the first ``grid.sync``, the owner
reduce, the second ``grid.sync``, the ``da`` reload, the update.

``--design cluster`` builds this tree's kernels with ``-DBAKP_PHASE_CLOCKS``
(``csrc/bakp_cluster.cuh``) and launches them through the package's own
wrappers.  With right-hand sides in groups a step holds one exchange a
group; the fused solve's x_shared regime has no ring, so its ring wait is
the step's start.  Phases: ring wait, the partials' FMAs, their butterfly
reduce-scatter and write, the push into the cluster and its mbarrier wait,
the rank-order sum with the cross-cluster exchange and the coefficients,
the ``da`` all-gather and its wait, the update, and a whole solve's
per-sweep SSE exchange spread over the sweep's steps.

``--no-clocks`` builds either design as it is (no stamps) and prints only
the times, so that the two designs can be compared unstamped in one run
on one card (parent, this tree, this tree, parent).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = {"grid": ["ring_wait", "partials_fma", "partials_sum_write",
                   "grid_sync_1", "owner_reduce", "grid_sync_2",
                   "da_reload", "update"],
          "cluster": ["ring_wait", "partials_fma", "partials_sum_write",
                      "push_wait", "cluster_sum", "da_gather", "update",
                      "sweep_sse"]}
# (kernel, vars, obs, block, k)
CASES = [("bakp_sweep", 256, 16384, 128, 1),
         ("bakp_sweep", 256, 16384, 128, 8),
         ("stream_solve", 4096, 16384, 128, 1),
         ("stream_solve", 4096, 16384, 128, 8),
         ("bakp_sweep", 1024, 262144, 256, 8),
         ("bakp_sweep", 4096, 16384, 128, 8),
         ("fused_solve", 256, 16384, 128, 1),
         ("fused_solve", 256, 16384, 128, 8),
         ("fused_solve", 512, 16384, 128, 8)]
# Kernels the grid-barrier design is stamped in.
GRID_KERNELS = ("bakp_sweep", "stream_solve")
SWEEPS = 20
MIN_OBS_PER_CTA = 128
STREAM_RED_FLOATS = 33

_STAMP = (
    "__device__ unsigned long long g_phase[9];\n"
    "#define PH_ON (blockIdx.x == 0 && threadIdx.x == 0)\n"
    "#define STAMP(i) do { const long long _t = clock64(); if (PH_ON) "
    "atomicAdd(&g_phase[i], (unsigned long long)(_t - _t0)); _t0 = _t; } "
    "while (0)\n"
    'extern "C" int bakp_timing(unsigned long long* out, int reset) {\n'
    "  if (reset) { const unsigned long long z[9] = {};\n"
    "    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z)); }\n"
    "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n")

# Text edits of the grid-barrier sources: file -> [(anchor, replacement)],
# each anchor found exactly once.
_EDITS = {
    "bakp_block.cuh": [
        ("namespace cg = cooperative_groups;\n",
         "namespace cg = cooperative_groups;\n" + _STAMP),
        ("  constexpr int CT = BAKP_COLS_PER_WARP;\n",
         "  constexpr int CT = BAKP_COLS_PER_WARP;\n"
         "  long long _ta = clock64(), _pa = 0, _pb = 0;\n"),
        ("#pragma unroll\n      for (int t = 0; t < CT; ++t)\n#pragma unroll\n"
         "        for (int r = 0; r < KC; ++r) {\n"
         "          const float v = warp_sum(acc[t][r]);\n",
         "      { const long long _t = clock64(); _pa += _t - _ta; _ta = _t; }\n"
         "#pragma unroll\n      for (int t = 0; t < CT; ++t)\n#pragma unroll\n"
         "        for (int r = 0; r < KC; ++r) {\n"
         "          const float v = warp_sum(acc[t][r]);\n"),
        ("part[(c0 + t) * k + r0 + r] = v;\n        }\n",
         "part[(c0 + t) * k + r0 + r] = v;\n        }\n"
         "      { const long long _t = clock64(); _pb += _t - _ta; _ta = _t; }\n"),
        ("    }\n  }\n}\n\n// Phase 2: fixed-order",
         "    }\n  }\n  if (PH_ON) { atomicAdd(&g_phase[1], "
         "(unsigned long long)_pa); atomicAdd(&g_phase[2], "
         "(unsigned long long)_pb); }\n}\n\n// Phase 2: fixed-order"),
        ("                          partials + blockIdx.x * n);\n  grid.sync();\n",
         "                          partials + blockIdx.x * n);\n"
         "  long long _t0 = clock64();\n  grid.sync();\n  STAMP(3);\n"),
        ("              inv_cn + (size_t)b * CB, CB, k, omega);\n  grid.sync();\n",
         "              inv_cn + (size_t)b * CB, CB, k, omega);\n  STAMP(4);\n"
         "  grid.sync();\n  STAMP(5);\n"),
        ("s_da[i] = __ldcg(da_buf + i);\n  __syncthreads();\n",
         "s_da[i] = __ldcg(da_buf + i);\n  __syncthreads();\n  STAMP(6);\n"),
        ("  bakp_update<KC, true>(xb, obs, e, obs, s_da, s.o0, s.o1, k, CB);\n"
         "  __syncthreads();\n",
         "  bakp_update<KC, true>(xb, obs, e, obs, s_da, s.o0, s.o1, k, CB);\n"
         "  __syncthreads();\n  STAMP(7);\n"
         "  if (PH_ON) atomicAdd(&g_phase[8], 1ull);\n"),
    ],
    "stream_solve.cu": [
        ("      const float* tile = ring + (size_t)(step & 1) * CB * L;\n",
         "      long long _t0 = clock64();\n"
         "      const float* tile = ring + (size_t)(step & 1) * CB * L;\n"),
        ("      __syncthreads();                 // ... and every thread's\n",
         "      __syncthreads();                 // ... and every thread's\n"
         "      STAMP(0);\n"),
        ("                               p.partials + blockIdx.x * nda);\n"
         "      grid.sync();\n",
         "                               p.partials + blockIdx.x * nda);\n"
         "      _t0 = clock64();\n      grid.sync();\n      STAMP(3);\n"),
        ("                  p.inv_cn + (size_t)b * CB, CB, k, p.omega);\n"
         "      grid.sync();\n",
         "                  p.inv_cn + (size_t)b * CB, CB, k, p.omega);\n"
         "      STAMP(4);\n      grid.sync();\n      STAMP(5);\n"),
        ("        s_da[i] = __ldcg(p.da_buf + i);\n      __syncthreads();\n",
         "        s_da[i] = __ldcg(p.da_buf + i);\n      __syncthreads();\n"
         "      STAMP(6);\n"),
        ("      __syncthreads();                 // `tile`'s stage may be "
         "refilled now\n",
         "      __syncthreads();                 // `tile`'s stage may be "
         "refilled now\n      STAMP(7);\n"
         "      if (PH_ON) atomicAdd(&g_phase[8], 1ull);\n"),
    ],
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GRID_SIGS = {
    "bakp_sweep": {"bakp_sweep_grid": [_I, _I, _P],
                   "bakp_sweep_launch": [_P] * 7 + [_I] * 4 + [_F, _I, _P],
                   "bakp_timing": [_P, _I]},
    "stream_solve": {"stream_solve_grid": [_I, _I, _P],
                     "stream_solve_launch": [_P] * 13 + [_I] * 5 + [_F] * 3
                     + [_I] * 2 + [_P],
                     "bakp_timing": [_P, _I]},
    "fused_solve": {"bakp_fused_grid": [_I, _I, _P],
                    "bakp_fused_launch": [_P] * 13 + [_I] * 5 + [_F] * 3
                    + [_I, _P]}}


def instrument(csrc: Path, work: Path) -> Path:
    """Copy the grid-barrier ``csrc`` to ``work/csrc`` with the stamps
    added; returns it."""
    dst = work / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for fname, edits in _EDITS.items():
        path = dst / fname
        text = path.read_text()
        for anchor, repl in edits:
            if text.count(anchor) != 1:
                raise SystemExit(
                    f"{path}: not the grid-barrier source (anchor "
                    f"{anchor[:50]!r} found {text.count(anchor)} times)")
            text = text.replace(anchor, repl)
        path.write_text(text)
    return dst


def build_grid(src: Path, work: Path, name: str, clocks: bool) -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = work / f"lib{name}-grid{'-clocks' if clocks else ''}.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(out), str(src / f"{name}.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, args in _GRID_SIGS[name].items():
        if fn == "bakp_timing" and not clocks:
            continue
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    return lib


def _slice_len(obs: int, grid: int) -> int:
    length = -(-obs // grid)
    return -(-length // 32) * 32


def grid_launcher(lib, name, x_t, inv, e, nv, no, block, k, torch):
    """A no-argument launch of the grid-barrier kernel, and its plan."""
    f32 = dict(dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gmax = _I(0)
    if name == "bakp_sweep":
        # The grid-barrier design's cooperative_grid: every CTA the card
        # holds at once (two an SM), at least MIN_OBS_PER_CTA obs each.
        if lib.bakp_sweep_grid(k, block, ctypes.addressof(gmax)):
            raise RuntimeError("bakp_sweep_grid failed")
        grid = max(1, min(gmax.value, -(-no // MIN_OBS_PER_CTA)))
        e_out = torch.empty_like(e)
        da = torch.empty((nv, k), **f32)
        partials = torch.empty((grid, block, k), **f32)
        da_buf = torch.empty((block, k), **f32)

        def launch():
            return lib.bakp_sweep_launch(
                x_t.data_ptr(), inv.data_ptr(), e.data_ptr(), e_out.data_ptr(),
                da.data_ptr(), partials.data_ptr(), da_buf.data_ptr(), nv, no,
                k, block, 1.0, grid, stream)
        return launch, {"ctas": grid}
    grid = max(1, min(sms, -(-no // MIN_OBS_PER_CTA)))
    L = _slice_len(no, grid)
    smem = 4 * (2 * block * L + k * L + block * k + STREAM_RED_FLOATS)
    if lib.stream_solve_grid(k, smem, ctypes.addressof(gmax)):
        raise RuntimeError("stream_solve_grid failed")
    if gmax.value < grid:
        raise RuntimeError(f"{grid} CTAs do not fit ({gmax.value})")
    a0 = torch.zeros((nv, k), **f32)
    outs = [torch.empty((nv, k), **f32), torch.empty_like(e),
            torch.empty((SWEEPS,), **f32), torch.empty((1,), **f32),
            torch.empty((1,), dtype=torch.int32, device="cuda"),
            torch.empty((1,), dtype=torch.int32, device="cuda"),
            torch.empty((grid, block, k), **f32),
            torch.empty((block, k), **f32), torch.empty((grid,), **f32)]

    def launch():
        return lib.stream_solve_launch(
            x_t.data_ptr(), inv.data_ptr(), e.data_ptr(), a0.data_ptr(),
            *[t.data_ptr() for t in outs], nv, no, k, block, SWEEPS, 0.0, 0.0,
            1.0, grid, smem, stream)
    return launch, {"ctas": grid, "L": L}


def cluster_launcher(name, x_t, inv, e, nv, no, block, k, torch,
                     zero_exchange=False):
    """A no-argument launch of this tree's kernel, its plan and the library
    (for the clock counters).  The sweep is launched through its C entry
    with the outputs made once, as ``grid_launcher`` launches the parent's,
    so that a short sweep is timed on the card and not in the wrapper's
    host work; ``zero_exchange`` zeroes the exchange words before each
    launch (what every launch did before the words carried a launch's tag
    base).  The two whole solves go through their wrappers."""
    import importlib
    from repro_torch.kernels import _build
    cd = importlib.import_module("repro_torch.kernels.cd_sweep")
    from repro_torch.kernels.fused_solve import fused_cuda
    from repro_torch.kernels.stream_solve import stream_cuda
    if name == "bakp_sweep":
        lib = _build.load(name)
        plan = cd.bakp_grid(lib.bakp_sweep_clusters, "sweep", no, k, block)
        e_out = torch.empty_like(e)
        da = torch.empty((nv, k), dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        regime = cd.BAKP_REGIMES.index(plan.regime)

        def launch():
            xchg, tag0 = cd.bakp_exchange(plan, x_t.device, nv // block)
            if zero_exchange and xchg is not None:
                xchg.zero_()
            return lib.bakp_sweep_launch(
                x_t.data_ptr(), x_t.element_size(), inv.data_ptr(),
                e.data_ptr(), e_out.data_ptr(), da.data_ptr(),
                None if xchg is None else xchg.data_ptr(),
                tag0, nv, no, k, block, 1.0, regime, plan.ctas, plan.cluster,
                int(plan.e_in == "shared"), plan.stages, plan.smem, stream)
        if launch():
            raise RuntimeError("bakp_sweep launch failed")
        return launch, plan._asdict(), lib
    else:
        a0 = torch.zeros((nv, k), dtype=torch.float32, device="cuda")
        solve = stream_cuda if name == "stream_solve" else fused_cuda

        def launch():
            solve(x_t, inv, e, a0, block=block, max_iter=SWEEPS,
                  atol_sse=0.0, rtol=0.0, omega=1.0)
            return 0
    launch()
    return launch, _build.PLANS[name]._asdict(), _build.load(name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--design", choices=("cluster", "grid"), default="cluster")
    ap.add_argument("--csrc", type=Path,
                    default=ROOT / "src/repro_torch/kernels/csrc",
                    help="csrc directory of the grid-barrier design")
    ap.add_argument("--work", type=Path,
                    default=ROOT / "src/repro_torch/kernels/build/bakp_phase_split",
                    help="build and output directory (git-ignored by default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clocks", action=argparse.BooleanOptionalAction,
                    default=True, help="build with the phase stamps")
    ap.add_argument("--kernels", nargs="+", default=None,
                    help="only the cases of these kernels")
    ap.add_argument("--zero-exchange", action="store_true",
                    help="cluster design: zero the sweep's exchange words "
                    "before each launch")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bakp_phase_split: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    args.work.mkdir(parents=True, exist_ok=True)
    design = args.design
    if design == "grid":
        src = instrument(args.csrc, args.work) if args.clocks else args.csrc
        libs = {n: build_grid(src, args.work, n, args.clocks)
                for n in GRID_KERNELS}
    else:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import _build
        if args.clocks:
            _build.NVCC_FLAGS.append("-DBAKP_PHASE_CLOCKS")
        _build.build_all(["bakp_sweep", "stream_solve", "fused_solve"])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for name, nv, no, block, k in CASES:
        if ((design == "grid" and name not in GRID_KERNELS)
                or (args.kernels is not None and name not in args.kernels)):
            continue
        x_t = torch.randn(nv, no, generator=gen, device="cuda")
        inv = 1.0 / (x_t * x_t).sum(1)
        e = torch.randn(k, no, generator=gen, device="cuda")
        if design == "grid":
            lib = libs[name]
            launch, plan = grid_launcher(lib, name, x_t, inv, e, nv, no,
                                         block, k, torch)
        else:
            launch, plan, lib = cluster_launcher(name, x_t, inv, e, nv, no,
                                                 block, k, torch,
                                                 args.zero_exchange)
            if args.clocks:
                lib.bakp_phase_clocks.argtypes = [_P, _I]
                lib.bakp_phase_clocks.restype = _I
        for _ in range(2):
            if launch():
                raise RuntimeError(f"{name} launch failed")
        torch.cuda.synchronize()
        iters = (3 if name == "stream_solve" or no > 100_000
                 else 10 if name == "fused_solve"
                 else 50 if nv <= 256 else 10)
        if not args.clocks:
            iters *= 3
        clocks = (None if not args.clocks else lib.bakp_timing
                  if design == "grid" else lib.bakp_phase_clocks)
        if clocks is not None:
            clocks(None, 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            launch()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        if clocks is None:
            row = {"design": design, "clocks": False,
                   "zeroed": args.zero_exchange, "kernel": name,
                   "vars": nv, "obs": no, "block": block, "k": k,
                   "plan": plan, "ms": ms}
            print(json.dumps(row), flush=True)
            rows.append(row)
            continue
        nph = len(PHASES[design])
        buf = (ctypes.c_ulonglong * 9)()
        if clocks(ctypes.addressof(buf), 0):
            raise RuntimeError("reading the phase clocks failed")
        steps = buf[8] / iters
        cyc = [buf[i] / buf[8] for i in range(nph)]
        us_step = ms * 1e3 / steps
        row = {"design": design, "kernel": name, "vars": nv, "obs": no,
               "block": block, "k": k, "plan": plan, "ms": ms,
               "steps_per_launch": steps, "us_per_step": us_step,
               "cycles_per_step": sum(cyc),
               "split_us": {p: c / sum(cyc) * us_step
                            for p, c in zip(PHASES[design], cyc)}}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x_t, e
    tag = design if args.clocks else f"{design}-noclocks"
    if args.zero_exchange:
        tag += "-zeroed"
    (args.work / f"split-{tag}.json").write_text(json.dumps(
        {"device": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
