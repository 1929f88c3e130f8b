"""Lanes and methods: per solver call, its right-hand sides to the device
(``design.y_to_device``) plus its coefficients and residuals back to the
host (``engine.result_to_host``); the median over the window's calls."""
from harness import spans


def read(run):
    held = spans.window_spans(run)
    return spans.median_ms(spans.copy_s(held)) if held else None
