"""Linear probing of LM activations with the BAK solver on the PyTorch
port — the paper's regression setting (tall systems: many tokens x d_model
features) applied inside the framework.

    PYTHONPATH=src python examples/torch_linear_probe.py [--device cpu]

The counterpart of ``examples/linear_probe.py``, with its printed lines:
a qwen3-family smoke model with random weights, frozen hidden states as
features, and a linear readout fitted with SolveBakP (gram mode) against
the LAPACK-style path for time and agreement.  It imports ``repro_torch``
only and runs on the GPU unless ``--device cpu``.
"""
import argparse
import time

import torch

from repro_torch.configs.registry import get
from repro_torch.core import fit_linear_probe, solve
from repro_torch.core.prepare import resolve_device
from repro_torch.models.model import (init_model, make_smoke_batch,
                                      probe_features)
from repro_torch.obs.trace import sync_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)

cfg = get("qwen3-8b").smoke()
params = init_model(cfg, seed=0, device=dev)

# extract frozen features for a batch of sequences
batch = make_smoke_batch(cfg, seed=1, batch=16, seq=64, device=dev)
with torch.no_grad():
    feats = probe_features(cfg, params, batch["tokens"])     # (1024, 64)
print(f"features: {tuple(feats.shape)} (tall system — the paper's regime)")

# synthetic probe target: depends on a sparse direction of the features
planted = torch.tensor([3, 11, 40], device=dev)
w_true = torch.zeros(cfg.d_model, device=dev)
w_true[planted] = torch.tensor([2.0, -1.5, 0.7], device=dev)
gen = torch.Generator(device=dev).manual_seed(2)
target = feats @ w_true + 0.01 * torch.randn(feats.shape[0], generator=gen,
                                             device=dev)

sync_device(dev)
t0 = time.perf_counter()
res = fit_linear_probe(feats, target, max_iter=100, rtol=1e-10, device=dev)
sync_device(dev)
t_bak = time.perf_counter() - t0

t0 = time.perf_counter()
ref = solve(feats, target, method="lstsq", device=dev)
sync_device(dev)
t_lapack = time.perf_counter() - t0

agree = float((res.coef - ref.coef).abs().max())
print(f"bak probe: {t_bak*1e3:.1f}ms  lapack: {t_lapack*1e3:.1f}ms  "
      f"max|Δcoef|={agree:.2e}")
print(f"probe recovers planted direction: "
      f"{[round(v, 2) for v in res.coef[planted].tolist()]}")
