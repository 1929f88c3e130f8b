"""Batched LM serving driver of the port: prefill a batch of prompts, then
decode tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

The counterpart of the JAX package's ``launch/serve.py``, with its three
printed lines.  Random weights and prompts from seed 0; greedy decode at
``--temperature 0``, else sampling from ``torch.Generator`` seeded 0.  The
cache holds ``max(max_cache_len, prompt + gen)`` slots (a sliding-window
layer's ring holds the window; an SSM model's states have no slots).  A
VLM prompt carries ``make_smoke_batch``'s M-RoPE position streams; decode
continues them from the cache's length.  An enc-dec prompt carries
``make_smoke_batch``'s frames (B, prompt-len, d_model) from the seed, so
``--prompt-len`` must not pass the config's ``src_len_for_decode`` (the
cross-attention cache's slots).  Every family runs (dense, MoE, VLM, SSM,
hybrid, enc-dec).  ``--device`` defaults to ``cuda`` and raises without a
GPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get
    from repro_torch.core.prepare import resolve_device
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.model import init_model, make_smoke_batch
    from repro_torch.obs.trace import sync_device

    cfg = get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)

    params = init_model(cfg, seed=0, device=dev)
    batch = make_smoke_batch(cfg, seed=0, batch=args.batch,
                             seq=args.prompt_len, device=dev)
    batch.pop("labels", None)

    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    cache = init_cache(cfg, args.batch,
                       max(cfg.max_cache_len, args.prompt_len + args.gen),
                       device=dev)
    sync_device(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    sync_device(dev)
    t_prefill = time.perf_counter() - t0

    gen = torch.Generator(device=dev).manual_seed(0)
    toks = []
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(args.gen):
        toks.append(tok[:, 0].cpu().numpy())
        logits, cache = decode(params, tok, cache)
        if args.temperature > 0:
            probs = torch.softmax(logits / args.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = logits.argmax(-1)[:, None]
        tok = tok.to(torch.int32)
    sync_device(dev)
    t_decode = time.perf_counter() - t0

    out = np.stack(toks, axis=1)
    print(f"prefill {args.prompt_len} tok x{args.batch}: {t_prefill:.3f}s")
    print(f"decode {args.gen} steps: {t_decode:.3f}s "
          f"({args.gen * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    print("generated ids:\n", out)
    return out


if __name__ == "__main__":
    main()
