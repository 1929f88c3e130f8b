"""End-to-end driver on the PyTorch port: train a reduced-config LM on the
synthetic pipeline with a checkpoint round trip, then serve a few tokens —
every substrate (data → train loop → checkpoint → restore →
prefill/decode).

    PYTHONPATH=src python examples/torch_train_tiny_lm.py \\
        [--arch h2o-danube-1.8b] [--steps 200] [--device cpu]

The counterpart of ``examples/train_tiny_lm.py``, with its printed lines.
It imports ``repro_torch`` only and runs on the GPU unless ``--device
cpu``.
"""
import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs.registry import get
from repro_torch.core.prepare import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.kvcache import init_cache
from repro_torch.models.model import init_model
from repro_torch.optim import make_optimizer

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="h2o-danube-1.8b")
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = dataclasses.replace(get(args.arch).smoke(), microbatch=1)
params = init_model(cfg, seed=0, device=dev)
opt_init, _ = make_optimizer(cfg.optimizer)
opt_state = opt_init(params)
data = SyntheticLM(cfg.vocab_size, 32, 16)
step_fn = make_train_step(cfg, peak_lr=3e-3, warmup=20,
                          total_steps=args.steps)

losses = []
for step in range(args.steps):
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.next_batch().items()}
    params, opt_state, m = step_fn(params, opt_state, batch, step)
    losses.append(float(m["ce_loss"]))
    if step % 25 == 0:
        print(f"step {step:4d}  ce={losses[-1]:.4f}")

print(f"loss: {np.mean(losses[:10]):.3f} -> {np.mean(losses[-10:]):.3f}")
assert np.mean(losses[-10:]) < np.mean(losses[:10])

with tempfile.TemporaryDirectory() as d:
    save_checkpoint(d, args.steps, {"params": params},
                    extras={"data_step": data.state.step})
    tree, extras, _ = restore_checkpoint(d, {"params": params}, device=dev)
    params = tree["params"]
    print(f"checkpoint roundtrip ok (data_step={extras['data_step']})")

# serve: prefill a learnable prompt, greedy-decode — the model should
# continue the (t+1) mod 97 pattern it was trained on.
prompt = torch.from_numpy(
    (np.arange(16) % 97).astype(np.int32)[None, :].repeat(2, 0)).to(dev)
cache = init_cache(cfg, 2, cfg.max_cache_len, device=dev)
prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
toks = []
with torch.no_grad():
    logits, cache = prefill(params, {"tokens": prompt}, cache)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    for _ in range(8):
        toks.append(int(tok[0, 0]))
        logits, cache = decode(params, tok, cache)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
print("prompt tail:", prompt[0, -4:].tolist(), " generated:", toks)
correct = sum(1 for i, t in enumerate(toks) if t == (16 + i) % 97)
print(f"pattern accuracy: {correct}/8")
