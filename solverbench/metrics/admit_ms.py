"""Dispatcher intake: median ``dispatch.admit`` span of the window's
requests (validation, the copy of y to the host, the design's
fingerprint and cache pre-warm, on the dispatch thread)."""
from harness import spans


def read(run):
    held = spans.window_spans(run)
    return spans.median_ms(spans.admit_s(held)) if held else None
