"""One run of one cell: set-up, warm-up, the measured window, the check.

Set-up draws the designs (through the configuration's design module) and
their right-hand sides on the device from the seed, starts the program
(``repro_torch.serve.AsyncDispatcher`` over a ``SolverServeEngine``, both
with their default configurations) and warms up every shape the mix uses
by driving its clients for a few rounds.  The window then drives them for
``seconds``; with a trace, a ``torch.profiler`` trace covers it.  Once
every reply is in, the peak of device memory is read, the program is
stopped and freed, the plain reference judges every coefficient vector a
request got back, and the design module checks what it made, where it has
a check.
"""
from __future__ import annotations

import contextlib
import gc
import statistics
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness import devtrace, spec
from harness.inputs import design_checks, make_designs
from harness.load import ClosedLoop, Done

ITEMSIZE = {"fp32": 4, "bf16": 2}


@dataclass(frozen=True)
class Solve:
    """One solver call that the window's requests rode in."""

    obs: int
    nvars: int
    k: int
    n_sweeps: int
    solve_s: float
    itemsize: int


@dataclass
class RunRecord:
    """What the metric readers (``metrics/<name>.py``) read."""

    seconds: float
    setup_s: float
    t_close: float
    requests: List[Done]
    solves: List[Solve]
    stats_delta: Dict[str, int]
    trace: Optional[devtrace.DeviceTrace]
    peaks: Optional[dict]
    work: Callable = None

    def answered_in_window(self) -> List[Done]:
        """Requests answered, without error, before the window closed."""
        return [r for r in self.requests
                if r.ok and r.t_done <= self.t_close]


@dataclass
class Outcome:
    result: dict                    # the result line, as a dict
    info: List[str] = field(default_factory=list)    # earlier stdout lines
    checks: List[str] = field(default_factory=list)  # last stderr lines
    readings: Dict[str, float] = field(default_factory=dict)


def distinct_solves(requests: List[Done], config: dict,
                    itemsize: int) -> List[Solve]:
    """The solves behind ``requests``: requests of one design fired in one
    batch rode in one solve, and share its telemetry."""
    seen = {}
    for r in requests:
        if r.solve_s is None or r.fired_at is None:
            continue
        key = (r.fired_at, r.design, r.solve_s, r.group_size)
        if key not in seen:
            seen[key] = Solve(obs=int(config["obs"]),
                              nvars=int(config["vars"]), k=int(r.group_size),
                              n_sweeps=int(r.n_sweeps), solve_s=r.solve_s,
                              itemsize=itemsize)
    return list(seen.values())


def _program(device):
    """The system under test with its default configurations."""
    from repro_torch.serve import (AsyncDispatcher, DispatchConfig,
                                   ServeConfig, SolverServeEngine)
    engine = SolverServeEngine(ServeConfig(), device=device)
    return engine, AsyncDispatcher(engine, DispatchConfig()).start()


def _nvidia_smi() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read: {exc}"


def _judge(designs, done: List[Done], ref) -> np.ndarray:
    """The reference's error of every answered request (NaN where no
    coefficients came back), in ``done``'s order."""
    err = np.full(len(done), np.nan)
    for d, design in enumerate(designs):
        rows = [i for i, r in enumerate(done)
                if r.design == d and r.coef is not None]
        if not rows:
            continue
        used = sorted({done[i].pool_idx for i in rows})
        a_ref = ref.solve(design.x, design.y_pool[used]).T   # (n, vars)
        at = {j: n for n, j in enumerate(used)}
        for lo in range(0, len(rows), 1024):
            chunk = rows[lo:lo + 1024]
            coef = np.stack([done[i].coef for i in chunk])
            want = a_ref[[at[done[i].pool_idx] for i in chunk]]
            err[chunk] = ref.coef_error(coef, want)
    return err


def reference_control(cell: spec.Cell, *, seed: int, device) -> dict:
    """The control the correctness limit has to fail: the plain reference
    put in the program's place, in TF32 (the nearest precision below the
    fp32 the configuration states), over every right-hand side of every
    design the cell draws from ``seed`` (through its design module, as a
    run draws them), judged as a run's answers are."""
    ref = spec.reference(cell.config["reference"])
    designs = make_designs(cell.config, cell.traffic, seed, device)
    worst = 0.0
    for design in designs:
        want = ref.solve(design.x, design.y_pool).T
        got = ref.solve(design.x, design.y_pool, precision="tf32").T
        worst = max(worst, float(ref.coef_error(got, want).max()))
    del designs
    return {"coef_err": worst}


def run_cell(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
             device, t_start: float,
             precision: Optional[str] = None) -> Outcome:
    """Run ``cell`` once, at the precision its configuration states.
    ``precision`` overrides it (a control runs the program's bf16 path);
    ``t_start`` is the clock at process start, which ``setup_s`` counts
    from."""
    from repro_torch import obs as rt_obs
    from repro_torch.kernels import _build
    from repro_torch.serve import SolveRequest

    config, traffic = cell.config, cell.traffic
    precision = precision or config["precision"]
    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    designs = make_designs(config, traffic, seed, device)
    solver = spec.solver_spec(traffic, precision)

    def make_request(d: int, idx: int):
        return SolveRequest(x=designs[d].x, y=designs[d].y_pool[idx],
                            spec=solver, design_key=designs[d].key)

    engine, disp = _program(device)
    loop = ClosedLoop(disp, designs, traffic, seed, make_request,
                      **({"span": torch.profiler.record_function}
                         if trace else {}))
    loop.run(rounds=int(traffic["warmup_rounds"]))
    if on_card:
        torch.cuda.synchronize(device)

    stats0 = engine.stats.as_dict()
    paths0 = rt_obs.dispatch_counts()
    launches0 = dict(_build.LAUNCHES)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with (torch.profiler.record_function(devtrace.WINDOW) if trace
          else contextlib.nullcontext()):
        done, t_first, t_close = loop.run(seconds=seconds)
        if on_card:
            torch.cuda.synchronize(device)
    if prof is not None:
        with warnings.catch_warnings():
            # Each trace is one cycle: its events are all there is.
            warnings.filterwarnings("ignore", message=".*clears events")
            prof.stop()
    setup_s = t_first - t_start
    stats1 = engine.stats.as_dict()
    paths1 = rt_obs.dispatch_counts()
    launches = {k: n - launches0.get(k, 0) for k, n in _build.LAUNCHES.items()
                if n - launches0.get(k, 0)}
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0

    info = []
    paths = {f"{p}:{m}": n - paths0.get((p, m), 0)
             for (p, m), n in paths1.items() if n - paths0.get((p, m), 0)}
    info.append(f"solverbench: kernel paths in the window {paths}")
    info.append(f"solverbench: kernel launches in the window {launches}, "
                f"last plans { {k: _build.PLANS.get(k) for k in launches} }")
    if on_card:
        info.append(f"solverbench: nvidia-smi {_nvidia_smi()}")

    disp.stop()
    engine.shutdown()
    del engine, disp, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    dtrace = devtrace.read(prof) if prof is not None else None
    del prof
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    record = RunRecord(
        seconds=float(seconds), setup_s=setup_s, t_close=t_close,
        requests=done,
        solves=distinct_solves(done, config, ITEMSIZE[precision]),
        stats_delta={k: stats1[k] - stats0.get(k, 0) for k in stats1},
        trace=dtrace, peaks=spec.peaks(kind),
        work=spec.work_counter(traffic["method"]))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m.name)(record)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}

    # The check, after the window and with the program freed.
    ref = spec.reference(config["reference"])
    errs = _judge(designs, done, ref)
    failed = sum(1 for r in done if not r.ok)
    answered = errs[~np.isnan(errs)]
    coef_err = float(answered.max()) if answered.size else float("inf")
    limit = config["check"]["coef_err"]
    checks = {"coef_err": {"value": coef_err, "limit": limit},
              "failed": {"value": failed, "limit": 0}}
    extra = design_checks(config, designs, device)
    checks.update({name: {"value": value, "limit": config["check"][name]}
                   for name, value in extra.items()})
    correct = answered.size > 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(done),
              "failed": failed, "metrics": metrics, "device": device_info}
    if dtrace is not None:
        device_info["busy_s"] = dtrace.busy_s
        device_info["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.device_ops,
                               "idle_gaps": dtrace.idle_gaps}
    result["checks"] = checks
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r}"
             for name, c in checks.items()]
    lines.append(f"check correct {bool(correct)} "
                 f"(compared {answered.size} of {len(done)} requests, "
                 f"median coef_err {statistics.median(answered.tolist()) if answered.size else float('nan')!r})")
    del designs
    return Outcome(result=result, info=info, checks=lines,
                   readings={"coef_err": coef_err, "failed": failed,
                             **extra})

