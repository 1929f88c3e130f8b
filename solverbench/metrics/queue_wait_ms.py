"""Dispatcher layer: median submit-to-fire wait of the window's requests
(``SolveTicket.queue_wait_s``)."""
import statistics


def read(run):
    waits = [r.queue_wait_s for r in run.requests
             if r.queue_wait_s is not None]
    return statistics.median(waits) * 1e3 if waits else None
