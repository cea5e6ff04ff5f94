"""End-to-end driver on the PyTorch port: train a ~100M-param qwen3-family
model for a few hundred steps on the synthetic pipeline with
checkpointing + watchdog; port of examples/train_lm.py.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \\
      [--device cpu] [--ckpt-dir DIR]

(Use --tiny for a quick smoke run through repro_torch.launch.train.)
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import main as train_main


def build_100m():
    # ~100M-param member of the qwen3 family
    base = get_config("qwen3_32b", reduced=True)
    return dataclasses.replace(
        base, name="qwen3-100m", num_layers=8, d_model=640, num_heads=10,
        num_kv_heads=2, d_ff=1792, vocab=32000, head_dim=64,
        vocab_round=128)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    if args.tiny:
        ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt")
        return train_main(["--arch", "qwen3_32b", "--reduced",
                           "--steps", str(min(args.steps, 30)),
                           "--global-batch", "4", "--seq", "32",
                           "--device", args.device, "--ckpt-dir", ckpt])

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import LoopConfig, make_train_step, train_loop

    cfg = build_100m()
    bundle = build_model(cfg, device=args.device)
    params = bundle.init(torch.Generator(bundle.device).manual_seed(0))
    nparams = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name}: {nparams/1e6:.1f}M params on {bundle.device}")
    opt = adamw(warmup_cosine(3e-4, 20, args.steps))
    state = {"params": params, "opt": opt.init(params)}
    data = SyntheticLM(cfg, DataConfig(8, 256, mode="learnable"))
    lc = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir or
                    os.path.join(tempfile.gettempdir(), "ckpt_100m"),
                    ckpt_every=100)
    stats = train_loop(make_train_step(bundle, opt), state, data, lc)
    print(f"final loss: {stats.last_loss:.4f} after {stats.steps_run} steps")
    return stats


if __name__ == "__main__":
    main()
