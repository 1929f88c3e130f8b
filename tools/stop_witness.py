#!/usr/bin/env python3
"""Where an rtol-1e-7 solve stops, and why, on one GPU.

    mkdir -p old && git archive 4d81b73 src/repro_torch/kernels/csrc | tar -x -C old
    python3 tools/stop_witness.py --parent-csrc old/src/repro_torch/kernels/csrc

At rtol 1e-7 the stopping rule (``sweep_stop_flags``) compares two fp32
SSEs whose difference is about one ulp, so two solvers that round
differently can stop a sweep or two apart.  This tool runs the same
systems through the whole-solve kernels and prints, sweep by sweep, each
one's fp32 SSE (the value its stopping rule reads), the SSE of its
residual summed in fp64 (its rounding of the iterate, without that of the
sum; the value it levels off at is its residual floor), and as a witness
the same iteration in fp64:

- ``kernel``: this tree's kernel; its residual after n sweeps comes from
  a launch with ``max_iter = n``;
- ``parent``: the kernel of ``--parent-csrc`` (the grid-barrier design of
  commit 4d81b73, called through ``ctypes``), when given, with its
  residual summed in fp64 as the kernel's (``parent64``) where the case
  has one;
- ``plain``: the plain version, and its residual's SSE in fp64 every
  sweep;
- ``host``: the out-of-core host-block loop (``stream_solve_blocks``),
  for the handle case;
- ``fp64``: the plain iteration in fp64 from the same start.

Cases (``--cases``):

- ``stream``: the streaming kernel (``stream_cuda``) on the phase 3
  design (16,384 x 4,096, thr 128, a noise-free planted system, k 1 and
  8, seeds ``--seeds``) and on the system of
  ``tests/test_torch_cuda.py::test_stream_handles_on_card`` (8,192 x 200,
  thr 64);
- ``fused``: on the phase 1 design (16,384 x 256, thr 128, noise-free,
  k 1 and 8, the same seeds), the Algorithm-2 whole-solve kernel
  (``fused_cuda``, ``variant="bakp"``) and the Algorithm-1 one
  (``variant="bak"``, no parent: the parent's is the same design), each
  beside its own plain iteration.

Writes every history to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

RTOL = 1e-7
MAX_ITER = 100


def sse64(e):
    return float((e.double() * e.double()).sum())


def iterate(alg, x_t, inv, e0, block, sweeps, dtype):
    """The plain iteration of Algorithm ``alg`` ("bakp" or "bak") in
    ``dtype``, as the plain versions step it (``cd_sweep.bakp_block_update``
    a block, ``cd_sweep.bak_row_update`` a column): after each sweep the
    SSE as the plain version sums it (``torch.dot``) and the residual's SSE
    summed in fp64."""
    import importlib
    import torch
    cd = importlib.import_module("repro_torch.kernels.cd_sweep")
    x = x_t.to(dtype)
    inv = inv.to(dtype).reshape(-1, 1)
    e = e0.to(dtype)
    dot, f64 = [], []
    for _ in range(sweeps):
        if alg == "bak":
            for j in range(x.shape[0]):
                _, e = cd.bak_row_update(x[j:j + 1], inv[j, 0], e)
        else:
            for b in range(0, x.shape[0], block):
                _, e = cd.bakp_block_update(x[b:b + block], inv[b:b + block],
                                            e, 1.0)
        dot.append(float(torch.dot(e.reshape(-1), e.reshape(-1))))
        f64.append(sse64(e))
    return dot, f64


def parent_stream(lib, x_t, inv, e0, block, max_iter, rtol, torch):
    """The grid-barrier streaming kernel: (history, n_sweeps)."""
    from bakp_phase_split import MIN_OBS_PER_CTA, STREAM_RED_FLOATS, _slice_len
    nv, no = x_t.shape
    k = e0.shape[0]
    f32 = dict(dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = max(1, min(sms, -(-no // MIN_OBS_PER_CTA)))
    L = _slice_len(no, grid)
    smem = 4 * (2 * block * L + k * L + block * k + STREAM_RED_FLOATS)
    gmax = ctypes.c_int(0)
    if lib.stream_solve_grid(k, smem, ctypes.addressof(gmax)) or gmax.value < grid:
        raise RuntimeError(f"parent stream_solve: {grid} CTAs do not fit")
    a0 = torch.zeros((nv, k), **f32)
    outs = [torch.empty((nv, k), **f32), torch.empty_like(e0),
            torch.empty((max_iter,), **f32), torch.empty((1,), **f32),
            torch.empty((1,), dtype=torch.int32, device="cuda"),
            torch.empty((1,), dtype=torch.int32, device="cuda"),
            torch.empty((grid, block, k), **f32),
            torch.empty((block, k), **f32), torch.empty((grid,), **f32)]
    err = lib.stream_solve_launch(
        x_t.data_ptr(), inv.data_ptr(), e0.data_ptr(), a0.data_ptr(),
        *[t.data_ptr() for t in outs], nv, no, k, block, max_iter, 0.0,
        float(rtol), 1.0, grid, smem, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent stream_solve_launch: cudaError_t {err}")
    n = int(outs[4][0])
    return outs[2][:n].tolist(), n


def parent_fused(lib, x_t, inv, e0, block, max_iter, rtol, torch):
    """The grid-barrier whole-solve kernel: (history, n_sweeps, e)."""
    nv, no = x_t.shape
    k = e0.shape[0]
    f32 = dict(dtype=torch.float32, device="cuda")
    gmax = ctypes.c_int(0)
    if lib.bakp_fused_grid(k, block, ctypes.addressof(gmax)):
        raise RuntimeError("parent bakp_fused_grid failed")
    grid = max(1, min(gmax.value, -(-no // 128)))
    a0 = torch.zeros((nv, k), **f32)
    outs = [torch.empty((nv, k), **f32), torch.empty_like(e0),
            torch.empty((max_iter,), **f32), torch.empty((1,), **f32),
            torch.empty((1,), dtype=torch.int32, device="cuda"),
            torch.empty((1,), dtype=torch.int32, device="cuda"),
            torch.empty((grid, block, k), **f32),
            torch.empty((block, k), **f32), torch.empty((grid,), **f32)]
    err = lib.bakp_fused_launch(
        x_t.data_ptr(), inv.data_ptr(), e0.data_ptr(), a0.data_ptr(),
        *[t.data_ptr() for t in outs], nv, no, k, block, max_iter, 0.0,
        float(rtol), 1.0, grid, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent bakp_fused_launch: cudaError_t {err}")
    n = int(outs[4][0])
    return outs[2][:n].tolist(), n, outs[1]


def run_case(name, x_t, inv, y, block, torch, solver="stream",
             parent_lib=None, host=None):
    """One system through one whole-solve kernel (``solver``: "stream",
    "fused" or "bak_fused") and its references."""
    from repro_torch.kernels.fused_solve import (fused_cuda,
                                                 fused_solve_plain, rtol_stop,
                                                 solve_init)
    from repro_torch.kernels.stream_solve import stream_cuda, stream_solve_plain
    multi = y.dim() == 2
    inv_cn, a0m, e0 = solve_init(x_t, y, inv, None, multi)
    kw = dict(block=block, atol_sse=0.0, omega=1.0)
    if solver == "stream":
        kernel, plain, alg = stream_cuda, stream_solve_plain, "bakp"
    else:
        alg = "bak" if solver == "bak_fused" else "bakp"
        kw["variant"] = alg
        kernel, plain = fused_cuda, fused_solve_plain
    sse0 = float(torch.dot(e0.reshape(-1), e0.reshape(-1)))
    row = {"case": name, "solver": solver, "shape": list(x_t.shape),
           "k": e0.shape[0], "block": block, "sse0": sse0}
    _, _, hk, _, nk, _ = kernel(x_t, inv_cn, e0, a0m, max_iter=MAX_ITER,
                                rtol=RTOL, **kw)
    nk = int(nk)
    _, ep, hp, _, npl, _ = plain(x_t, inv_cn, e0, a0m, max_iter=MAX_ITER,
                                 rtol=RTOL, **kw)
    npl = int(npl)
    row["plain_final_f64sum"] = sse64(ep)
    parent = None
    if parent_lib is not None:
        run = parent_stream if solver == "stream" else parent_fused
        inv_c, e0c = inv_cn.float().contiguous(), e0.contiguous()

        def parent(m, rtol):
            return run(parent_lib, x_t, inv_c, e0c, block, m, rtol, torch)
        out = parent(MAX_ITER, RTOL)
        row["parent_f32"], row["n_parent"] = out[0], out[1]
    sweeps = max(nk, npl, row.get("n_parent", 0)) + 3
    row["n"] = {"kernel": nk, "plain": npl}
    if parent is not None:
        row["n"]["parent"] = row.pop("n_parent")
    row["kernel_f32"] = hk[:nk].tolist()
    row["plain_f32"], row["plain_f64sum"] = iterate(alg, x_t, inv_cn, e0,
                                                    block, sweeps, torch.float32)
    # The kernels' residuals after n sweeps, summed in fp64.
    lo = max(1, min(row["n"].values()) - 5)
    row["kernel_f64sum"], row["parent_f64sum"] = {}, {}
    for m in range(lo, sweeps + 1):
        _, em, _, _, _, _ = kernel(x_t, inv_cn, e0, a0m, max_iter=m,
                                   rtol=0.0, **kw)
        row["kernel_f64sum"][m] = sse64(em)
        if parent is not None and solver != "stream":
            row["parent_f64sum"][m] = sse64(parent(m, 0.0)[2])
    if host is not None:
        rh = host()
        row["n"]["host"] = int(rh.n_sweeps)
        row["host_f32"] = rh.history[:int(rh.n_sweeps)].tolist()
    row["fp64"] = iterate(alg, x_t, inv_cn, e0, block, sweeps,
                          torch.float64)[1]
    row["stop_on_plain_f64sum"] = rtol_stop(row["plain_f64sum"], sse0, RTOL)
    row["stop_on_fp64"] = rtol_stop(row["fp64"], sse0, RTOL)
    # Residual floors: the least fp64 SSE each iterate reaches.
    row["floor"] = {"kernel": min(row["kernel_f64sum"].values()),
                    "plain": min(row["plain_f64sum"]),
                    "fp64": min(row["fp64"])}
    if row["parent_f64sum"]:
        row["floor"]["parent"] = min(row["parent_f64sum"].values())
    torch.cuda.synchronize()
    return row


def show(row):
    print(f"== {row['case']} {row['solver']} {row['shape']} k {row['k']} "
          f"thr {row['block']}: n_sweeps {row['n']}; the rule on plain's "
          f"residual summed in fp64 stops at {row['stop_on_plain_f64sum']}, "
          f"on the fp64 iteration at {row['stop_on_fp64']}; residual floors "
          f"(fp64 SSE) {row['floor']}", flush=True)
    cols = [("kernel", row["kernel_f32"]), ("kernel64", row["kernel_f64sum"]),
            ("parent", row.get("parent_f32")),
            ("parent64", row["parent_f64sum"] or None),
            ("plain", row["plain_f32"]), ("plain64", row["plain_f64sum"]),
            ("host", row.get("host_f32")), ("fp64", row["fp64"])]
    cols = [(c, h) for c, h in cols if h is not None]
    print("   n " + " ".join(f"{c:>16}" for c, _ in cols))
    lo = min(row["kernel_f64sum"])
    for m in range(lo, len(row["fp64"]) + 1):
        vals = []
        for _, h in cols:
            if isinstance(h, dict):
                v = h.get(m)
            else:
                v = h[m - 1] if m - 1 < len(h) else None
            vals.append(f"{v:16.9e}" if v is not None else f"{'':>16}")
        print(f"  {m:2d} " + " ".join(vals))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="csrc of the grid-barrier design (commit 4d81b73)")
    ap.add_argument("--cases", nargs="+", choices=("stream", "fused"),
                    default=["stream", "fused"])
    ap.add_argument("--work", type=Path,
                    default=ROOT / "src/repro_torch/kernels/build/stop_witness")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("stop_witness: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from repro_torch.core import SolverSpec, prepare, prepared_from_arrays
    from repro_torch.kernels import _build
    _build.build_all(["stream_solve", "fused_solve", "bak_fused"])
    parents = {}
    if args.parent_csrc is not None:
        from bakp_phase_split import build_grid
        args.work.mkdir(parents=True, exist_ok=True)
        for name in ("stream_solve", "fused_solve"):
            parents[name] = build_grid(args.parent_csrc, args.work, name,
                                       False)
    rows = []
    if "stream" in args.cases:
        # The handle test's system, through both handles as the test calls
        # them.
        rng = np.random.default_rng(54)
        x = rng.normal(size=(8192, 200)).astype(np.float32)
        a = rng.normal(size=(200,)).astype(np.float32)
        xc = torch.tensor(x, device="cuda")
        yc = torch.tensor(x @ a, device="cuda")
        spec = SolverSpec(method="bakp_stream", thr=64, rtol=RTOL,
                          max_iter=MAX_ITER)
        p = prepare(xc, spec)
        h = prepared_from_arrays(xc, resident=False, spec=spec)
        rows.append(run_case("handle_test", p.x_t_for(64), p.inv_cn_for(64),
                             yc, 64, torch,
                             parent_lib=parents.get("stream_solve"),
                             host=lambda: h.solve(yc)))
        show(rows[-1])
    for seed in args.seeds:
        for case, (obs, nvars) in (("stream", (16_384, 4_096)),
                                   ("fused", (16_384, 256))):
            if case not in args.cases:
                continue
            gen = torch.Generator(device="cuda").manual_seed(seed)
            xs = torch.randn(obs, nvars, generator=gen, device="cuda")
            ps = prepare(xs, SolverSpec(method="bakp_stream", thr=128))
            x_t, inv = ps.x_t_for(128), ps.inv_cn_for(128)
            name = f"{'p3' if case == 'stream' else 'p1'}_seed{seed}"
            for k in (1, 8):
                a_s = torch.randn(nvars, k, generator=gen, device="cuda")
                ys = (xs @ a_s)[:, 0] if k == 1 else xs @ a_s
                solvers = ("stream",) if case == "stream" else ("fused",
                                                                "bak_fused")
                for solver in solvers:
                    kernel = "stream_solve" if solver == "stream" else (
                        "fused_solve" if solver == "fused" else None)
                    rows.append(run_case(name, x_t, inv, ys, 128, torch,
                                         solver=solver,
                                         parent_lib=parents.get(kernel)))
                    show(rows[-1])
            del xs, ps, x_t
    if args.out is not None:
        args.out.write_text(json.dumps({"device": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
