"""Solver loop: mean sweeps of the window's solver calls."""


def read(run):
    sweeps = [s.n_sweeps for s in run.solves]
    return sum(sweeps) / len(sweeps) if sweeps else None
