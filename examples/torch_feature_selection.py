"""SolveBakF (Algorithm 3) for feature selection on the PyTorch port —
paper §8 + Fig 2.

    PYTHONPATH=src python examples/torch_feature_selection.py [--device cpu]

The counterpart of ``examples/feature_selection.py``, with its printed
lines; it imports ``repro_torch`` only and runs on the GPU unless
``--device cpu``.  Times end in a device synchronise.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import solvebakf, stepwise_regression_baseline
from repro_torch.core.prepare import resolve_device
from repro_torch.obs.trace import sync_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)

rng = np.random.default_rng(0)
obs, nvars, k = 4000, 128, 6
x = rng.normal(size=(obs, nvars)).astype(np.float32)
idx = sorted(rng.choice(nvars, size=k, replace=False).tolist())
coef = np.zeros(nvars, np.float32)
coef[idx] = 3 * rng.normal(size=k).astype(np.float32) + 1.0
y = x @ coef + 0.05 * rng.normal(size=obs).astype(np.float32)
xt, yt = torch.tensor(x, device=dev), torch.tensor(y, device=dev)

sync_device(dev)
t0 = time.perf_counter()
sel = solvebakf(xt, yt, max_feat=k)
sync_device(dev)
t_fast = time.perf_counter() - t0

t0 = time.perf_counter()
sw = stepwise_regression_baseline(xt, yt, max_feat=k)
sync_device(dev)
t_slow = time.perf_counter() - t0

print(f"planted   : {idx}")
print(f"solvebakf : {sorted(sel.selected.cpu().tolist())}  "
      f"({t_fast*1e3:.0f}ms)")
print(f"stepwise  : {sorted(sw.selected.cpu().tolist())}  "
      f"({t_slow*1e3:.0f}ms)")
print(f"speed-up  : {t_slow/t_fast:.1f}x (paper Fig 2 shows the same gap "
      f"growing with vars)")
print("SSE path  :", [f"{v:.3e}" for v in sel.sse_path.cpu().numpy()])
