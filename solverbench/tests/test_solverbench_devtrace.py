"""Busy time, idle gaps and readers, on a synthetic trace."""
from types import SimpleNamespace

from sbtest import spec
from harness import devtrace


class _Ev:
    def __init__(self, name, dev, s, e):
        self._n, self._d, self._s, self._e = name, dev, s, e

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_busy_is_union_and_gaps_are_named():
    ms = 1_000_000
    evs = [_Ev("sb.window", False, 0, 100 * ms),
           _Ev("sb.result_wait", False, 0, 60 * ms),
           _Ev("sb.submit", False, 60 * ms, 100 * ms),
           _Ev("kernA", True, 10 * ms, 30 * ms),
           _Ev("kernB", True, 20 * ms, 40 * ms),   # overlaps kernA
           _Ev("Memcpy HtoD (Pageable -> Device)", True, 70 * ms, 75 * ms),
           _Ev("kernA", True, 150 * ms, 160 * ms)]  # outside the window
    t = devtrace.read(_prof(evs))
    assert abs(t.window_s - 0.1) < 1e-12
    assert abs(t.busy_s - 0.035) < 1e-12
    assert abs(t.kernel_s - 0.030) < 1e-12      # the copy is not a kernel
    assert t.device_ops[0] == ["kernA", 0.02]
    names = [g[0].split(" / ")[0] for g in t.idle_gaps]
    secs = [g[1] for g in t.idle_gaps]
    assert secs == sorted(secs, reverse=True)
    assert abs(secs[0] - 0.03) < 1e-12 and names[0] == "sb.result_wait"
    assert "sb.submit" in names


def test_readers_leave_out_what_they_cannot_read():
    run = SimpleNamespace(trace=None, peaks=None, solves=[], requests=[],
                          stats_delta={"multi_rhs_groups": 0,
                                       "single_solves": 0, "vmap_batches": 0,
                                       "multi_rhs_requests": 0,
                                       "vmap_requests": 0})
    for name in ("solve_roofline_pct", "device_idle_pct", "rhs_per_solve",
                 "solve_ms", "sweeps_per_solve", "queue_wait_ms",
                 "latency_p95_ms"):
        assert spec.metric_reader(name)(run) is None, name


def test_roofline_reader():
    peaks = spec.peaks("NVIDIA H100 80GB HBM3")
    solve = SimpleNamespace(obs=16384, nvars=4096, k=16, n_sweeps=35,
                            itemsize=4)
    run = SimpleNamespace(
        trace=SimpleNamespace(busy_s=0.03, kernel_s=0.028, window_s=0.04),
        peaks=peaks,
        solves=[solve] * 2, work=spec.work_counter("bakp_stream"))
    pct = spec.metric_reader("solve_roofline_pct")(run)
    assert abs(pct - 100 * 2 * 2.8058e-3 / 0.028) < 0.01
    assert abs(spec.metric_reader("device_idle_pct")(run) - 25.0) < 1e-9
