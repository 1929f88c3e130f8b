"""End-to-end training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --smoke --steps 200 --ckpt-dir DIR [--resume] [--device cpu]

The counterpart of the JAX package's ``launch/train.py``, with its flags
and printed lines, on one device (the sharded substrate is ROADMAP.md
queue 1 item 3): random weights from seed 0, the config's optimizer, the
``SyntheticLM`` stream (seed 17), ``make_train_step`` at ``microbatch`` 1
with a 20-step warmup over ``--steps``, a ``StragglerMonitor``, and with
``--ckpt-dir`` a ``CheckpointManager`` (a save every ``--ckpt-every``
steps and after SIGTERM) whose checkpoints hold {"params", "opt"} and the
data stream's position.  ``--resume`` restores the newest checkpoint and
continues with the step after it on the stream's next batch, so a resumed
run repeats the steps of an uninterrupted one (JAX's driver runs the
checkpoint's step index once more on that batch).  A VLM batch carries
``arange`` M-RoPE streams; an enc-dec batch frames (B, S, d_model) drawn
from ``torch.Generator(device).manual_seed(step)``, a function of the step
as JAX's ``fold_in`` draw is (whose stream is not reproduced).
``--device`` defaults to ``cuda`` and raises without a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get
    from repro_torch.core.prepare import resolve_device
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.fault_tolerance import (CheckpointManager,
                                                         StragglerMonitor)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_model
    from repro_torch.optim import make_optimizer

    cfg = get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, microbatch=1)
    dev = resolve_device(args.device)

    params = init_model(cfg, seed=0, device=dev)
    opt_init, _ = make_optimizer(cfg.optimizer)
    opt_state = opt_init(params)
    step0 = 0

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    mon = StragglerMonitor()
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir,
                                 interval_steps=args.ckpt_every)
        ckpt.install_preemption_handler()
        if args.resume and ckpt.latest_step() is not None:
            state, extras, saved = ckpt.restore_latest(
                {"params": params, "opt": opt_state}, device=dev)
            params, opt_state = state["params"], state["opt"]
            step0 = saved + 1
            data.skip_to(extras.get("data_step", step0))
            print(f"resumed from step {saved}")

    train_step = make_train_step(cfg, peak_lr=args.lr, warmup=20,
                                 total_steps=args.steps)

    losses = []
    for step in range(step0, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.next_batch().items()}
        b, s = batch["tokens"].shape
        if cfg.family == "vlm":
            ar = torch.arange(s, dtype=torch.int32, device=dev)
            batch["positions"] = ar[None, None].expand(3, b, s)
        if cfg.family == "encdec":
            gen = torch.Generator(device=dev).manual_seed(step)
            batch["frames"] = torch.randn((b, s, cfg.d_model), generator=gen,
                                          device=dev)
        mon.step_start()
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                step)
        losses.append(float(metrics["ce_loss"]))
        straggler = mon.step_end()
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} ce={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e}"
                  + (" [straggler]" if straggler else ""), flush=True)
        if ckpt and ckpt.should_save(step):
            ckpt.save(step, {"params": params, "opt": opt_state},
                      extras={"data_step": data.state.step})

    print(f"final: first10={np.mean(losses[:10]):.3f} "
          f"last10={np.mean(losses[-10:]):.3f} "
          f"straggler_summary={mon.summary()}")
    return losses


if __name__ == "__main__":
    main()
