"""What a ``torch.profiler`` trace of the window says about the device.

The busy time is the union of the device's operation intervals (kernels,
copies, fills) inside the window, so overlapping streams count once; the
kernel time is the union of the kernels' intervals alone (no ``Memcpy`` or
``Memset``), so taking a copy off the device moves no kernel's share.  The
window is the harness's own ``sb.window`` annotation, on the profiler's
clock.  The idle gaps between device operations are named by the
harness's span around its calls into the program (``sb.submit``,
``sb.result_wait``) that covers most of each gap, and beside it by the
program's host operation (an aten op or a CUDA runtime call, on any
thread) that covers most of it.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

WINDOW = "sb.window"
SPAN_PREFIX = "sb."
TOP = 10
#: Host events longer than this (a thread's whole wait) name no gap.
LONGEST_HOST_NS = 1_000_000_000
#: Device events that are copies or fills, not kernels.
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    kernel_s: float
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event of ``prof``."""
    return [(e.name(), str(e.device_type()).endswith("CUDA"),
             e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _most(gap, events, default: str) -> str:
    cover = defaultdict(int)
    g0, g1 = gap
    for name, s, e in events:
        if s < g1 and e > g0:
            cover[name] += min(e, g1) - max(s, g0)
    if not cover:
        return default
    return max(cover.items(), key=lambda kv: kv[1])[0]


def _label(gap, spans, host) -> str:
    return (_most(gap, spans, "outside the harness's spans") + " / "
            + _most(gap, host, "no host op"))


def read(prof) -> DeviceTrace:
    events = _events(prof)
    windows = [(s, e) for n, dev, s, e in events if n == WINDOW and not dev]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    w0, w1 = windows[0]
    busy_iv, kernel_iv, per_op = [], [], defaultdict(int)
    spans, host = [], []
    for name, dev, s, e in events:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if dev:
            busy_iv.append((s, e))
            if not name.startswith(NOT_KERNELS):
                kernel_iv.append((s, e))
            per_op[name[:160]] += e - s
        elif name.startswith(SPAN_PREFIX):
            if name != WINDOW:
                spans.append((name, s, e))
        elif e - s < LONGEST_HOST_NS:
            host.append((name[:80], s, e))
    busy = union(busy_iv)
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    return DeviceTrace(
        busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
        kernel_s=sum(e - s for s, e in union(kernel_iv)) / 1e9,
        device_ops=[[n, ns / 1e9] for n, ns in ops],
        idle_gaps=[[f"{_label(g, spans, host)} at +{(g[0] - w0) / 1e9:.3f} s",
                    (g[1] - g[0]) / 1e9] for g in gaps[:TOP]])
