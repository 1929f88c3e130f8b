"""95th percentile of submit-to-result time, on the harness's clock, of
every request sent in the window and answered (numpy's linear
interpolation between order statistics)."""
import numpy as np


def read(run):
    lat = [r.latency_s for r in run.requests if r.ok]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
