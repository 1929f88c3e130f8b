"""Lanes and methods: median wall time of the window's solver calls
(``SolveTelemetry.solve_s``, which ends after the lane's stream was
synchronised), one reading a call."""
import statistics


def read(run):
    times = [s.solve_s for s in run.solves]
    return statistics.median(times) * 1e3 if times else None
