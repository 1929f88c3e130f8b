"""Engine coalescing: per solver call, ``engine.pad`` plus the own time of
``engine.strip`` (its ``engine.result_to_host`` copy left out); the
median over the window's calls."""
from harness import spans


def read(run):
    held = spans.window_spans(run)
    return spans.median_ms(spans.pad_strip_s(held)) if held else None
