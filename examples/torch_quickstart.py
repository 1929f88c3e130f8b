"""Quickstart on the PyTorch port: solve linear systems with the BAK family.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py``, with its printed lines; it
imports ``repro_torch`` only and runs on the GPU unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import solve, solvebak, solvebakf
from repro_torch.core.prepare import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)


def t(a):
    return torch.tensor(a, device=dev)


rng = np.random.default_rng(0)

# -- a tall system (the paper's main regime): 20k observations, 256 vars ---
x = rng.normal(size=(20_000, 256)).astype(np.float32)
a_true = rng.normal(size=(256,)).astype(np.float32)
y = x @ a_true + 0.01 * rng.normal(size=20_000).astype(np.float32)

res = solve(t(x), t(y), method="bakp_gram", thr=128, max_iter=50, rtol=1e-9,
            device=dev)
print(f"[bakp_gram] sweeps={int(res.n_sweeps)} "
      f"rmse={float(torch.sqrt(res.sse / 20_000)):.2e} "
      f"coef_err={float((res.coef - t(a_true)).abs().max()):.2e}")

# -- paper-faithful Algorithm 1, with SSE history (Theorem 1) --------------
res1 = solvebak(t(x), t(y), max_iter=10)
h = res1.history.cpu().numpy()
print("[bak] SSE per sweep:", " ".join(f"{v:.3e}" for v in h[:8]))
assert np.all(np.diff(h[~np.isnan(h)]) <= 1e-3 * h[~np.isnan(h)][:-1] + 1e-6), \
    "Theorem 1 violated?!"

# -- wide system: more unknowns than equations -----------------------------
xw = rng.normal(size=(128, 2048)).astype(np.float32)
yw = rng.normal(size=(128,)).astype(np.float32)
resw = solve(t(xw), t(yw), method="bakp_gram", thr=128, max_iter=50,
             device=dev)
print(f"[wide] residual={float(resw.sse):.2e} (exact solution found)")

# -- greedy feature selection (Algorithm 3) --------------------------------
coef = np.zeros(256, np.float32)
planted = [7, 80, 201]
coef[planted] = [4.0, -3.0, 5.0]
ys = x @ coef + 0.01 * rng.normal(size=20_000).astype(np.float32)
sel = solvebakf(t(x), t(ys), max_feat=3)
print(f"[bakf] planted={sorted(planted)} "
      f"selected={sorted(sel.selected.cpu().tolist())}")
