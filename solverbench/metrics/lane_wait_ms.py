"""Lanes: median fire-to-start wait of the window's requests, from the
``lane_wait_s`` tag of each batch's ``dispatch.solve_batch`` span (the
lane's queue, and its thread's hand-over)."""
from harness import spans


def read(run):
    held = spans.window_spans(run)
    return spans.median_ms(spans.lane_wait_s(held)) if held else None
