"""Training driver; port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_32b \\
      --reduced --steps 100 --global-batch 8 --seq 64 --ckpt-dir DIR \\
      [--device cpu]

Builds the model on ``--device`` (default ``cuda``: without a card that
raises), AdamW with a 10-step warmup and cosine decay, and runs
``train_loop`` with checkpoints every ``--ckpt-every`` steps (resuming
from the latest in ``--ckpt-dir``) and the straggler watchdog.

Sharded, one process a card, under ``torchrun``:

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3_32b \
      --reduced --model-axis 2 [--device cpu]

``WORLD_SIZE`` > 1 starts the process group from torchrun's environment
(``nccl`` on ``cuda``, one card a rank by ``LOCAL_RANK``; ``gloo`` on
``--device cpu``) and trains on the mesh ``make_local_mesh`` builds:
(world // model_axis, model_axis) over ('data', 'model'). Every rank
inits the same params from seed 0 and places its shards; only rank 0
prints. One process without torchrun trains on one device as before
(``--model-axis`` must then be 1).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..configs.base import ARCH_IDS, get_config
from ..data import DataConfig, SyntheticLM
from ..distributed.sharding import param_shardings
from ..models import build_model
from ..optim import adamw, warmup_cosine
from ..train import (LoopConfig, make_accum_train_step, make_train_step,
                     train_loop)

__all__ = ["main", "make_local_mesh"]


def make_local_mesh(model_axis: int = 1, device: str = "cuda"):
    """The (world // model_axis, model_axis) mesh over ('data', 'model')
    of the started process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world % model_axis:
        raise ValueError(f"--model-axis {model_axis} does not divide the "
                         f"world of {world} processes")
    return init_device_mesh(torch.device(device).type,
                            (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def _start(device: str) -> str:
    """Start the process group under torchrun; the rank's device."""
    import torch.distributed as dist
    if torch.device(device).type == "cuda":
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local))
        return f"cuda:{local}"
    dist.init_process_group("gloo")
    return device


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
    sharded = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if not sharded and args.model_axis != 1:
        raise ValueError("--model-axis > 1 needs one process a device "
                         "(run under torchrun)")
    device = _start(args.device) if sharded else args.device
    mesh = make_local_mesh(args.model_axis, device) if sharded else None

    cfg = get_config(args.arch, reduced=args.reduced)
    bundle = build_model(cfg, device=device)
    opt = adamw(warmup_cosine(args.lr, 10, args.steps))
    params = bundle.init(torch.Generator(bundle.device).manual_seed(0))
    if mesh is not None:
        param_shardings(mesh, params)
    state = {"params": params, "opt": opt.init(params)}

    if args.accum > 1:
        raw = make_accum_train_step(bundle, opt, args.accum, mesh=mesh)
    else:
        raw = make_train_step(bundle, opt, mesh=mesh)

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
    if not sharded or torch.distributed.get_rank() == 0:
        print(f"done: steps={stats.steps_run} loss={stats.last_loss:.4f} "
              f"restores={stats.restores} stragglers={stats.stragglers} "
              f"tokens/s={tok/dt:.0f}")
    if sharded:
        torch.distributed.destroy_process_group()
    return stats


if __name__ == "__main__":
    main()
