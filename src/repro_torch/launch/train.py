"""Training driver; port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_32b \\
      --reduced --steps 100 --global-batch 8 --seq 64 --ckpt-dir DIR \\
      [--device cpu]

Builds the model on ``--device`` (default ``cuda``: without a card that
raises), AdamW with a 10-step warmup and cosine decay, and runs
``train_loop`` with checkpoints every ``--ckpt-every`` steps (resuming
from the latest in ``--ckpt-dir``) and the straggler watchdog. One card:
``--model-axis`` > 1 (tensor-parallel sharding) is refused.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..configs.base import ARCH_IDS, get_config
from ..data import DataConfig, SyntheticLM
from ..models import build_model
from ..optim import adamw, warmup_cosine
from ..train import (LoopConfig, make_accum_train_step, make_train_step,
                     train_loop)

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_32b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-mode", default="learnable",
                    choices=["learnable", "random"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_axis != 1:
        raise NotImplementedError(
            "--model-axis > 1 needs the sharded training path, which is "
            "not ported yet; this driver trains on one device")

    cfg = get_config(args.arch, reduced=args.reduced)
    bundle = build_model(cfg, device=args.device)
    opt = adamw(warmup_cosine(args.lr, 10, args.steps))
    params = bundle.init(torch.Generator(bundle.device).manual_seed(0))
    state = {"params": params, "opt": opt.init(params)}

    if args.accum > 1:
        raw = make_accum_train_step(bundle, opt, args.accum)
    else:
        raw = make_train_step(bundle, opt)

    def step_fn(p, o, batch):
        if args.accum > 1:
            batch = {k: v.reshape(args.accum, v.shape[0] // args.accum,
                                  *v.shape[1:]) for k, v in batch.items()}
        return raw(p, o, batch)

    data = SyntheticLM(cfg, DataConfig(args.global_batch, args.seq,
                                       mode=args.data_mode))
    lc = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every)
    t0 = time.time()
    stats = train_loop(step_fn, state, data, lc,
                       on_straggler=lambda s, r: print(
                           f"[watchdog] step {s} straggled {r:.1f}x"))
    dt = time.time() - t0
    tok = stats.steps_run * args.global_batch * args.seq
    print(f"done: steps={stats.steps_run} loss={stats.last_loss:.4f} "
          f"restores={stats.restores} stragglers={stats.stragglers} "
          f"tokens/s={tok/dt:.0f}")
    return stats


if __name__ == "__main__":
    main()
