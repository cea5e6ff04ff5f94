"""Pod-scale dry run of the LM scaffold; port of ``repro.launch.dryrun``.

The JAX package lowers and compiles every (arch x shape x mesh) cell
ahead of time and reads XLA's memory analysis and the partitioned HLO. The
port has no compiler. It runs each cell's step once on fake tensors (no
storage) under a fake process group of the production world size, as rank
0, and counts what that card executes (``op_cost``): FLOPs, HBM bytes,
collective bytes by kind and by the mesh axes they cross, and the peak of
the live bytes. ``roofline.analyze`` turns them into JAX's row. Per cell:

  * the model is built with ``remat``, its params placed by
    ``param_shardings`` (``strategy``), and for a train cell AdamW's fp32
    moments beside them; the train step (``train.step.make_train_step``),
    the prefill (``make_prefill_step``) or one decode step
    (``make_decode_step``, the cache placed by ``cache_specs``) runs on a
    batch of ``models.batch_spec``'s shapes, under JAX's choice of batch
    axes and data size (``activation_axes``; the steps place the batch
    by ``batch_specs(strategy=)``, so under ``fsdp`` a batch that does
    not cover every axis is whole on each card, where JAX splits it over
    the data axes and the sequence over 'model');
  * ``params``, ``active_params`` and ``model_flops`` are counted as the
    JAX package counts them (6 or 2 x active params x tokens);
  * the bytes of the params, grads and fp32 moments each card holds under
    ``param_specs`` (``bytes_per_card``; a dim split over n shards holds
    ceil(dim / n) on the fullest card), and whether the traced peak fits
    the card's ``HW.HBM_BYTES``.

A full-size cell's trace takes from seconds (a decode step) to about 15
minutes (a MoE prefill of 32768 tokens), ``--all`` 80-85 minutes a mesh on
one core; no card is needed. Meshes: 256 cards as (data 32, model 8), 512 as (pod 2, data 32,
model 8). The model axis is one NVLink node of 8 H100s; the data and pod
axes cross nodes. The TPU pod the JAX package targets had (16, 16).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_32b \\
      --shape train_4k [--multi-pod] [--strategy tp|fsdp] \\
      [--remat full|dots|none] [--moe-cap C] [--attn-chunk N] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-existing]

Each row is printed as JSON on stdout (a one-line summary on stderr) and
written to ``DIR/<arch>_<shape>_<mesh><tag>.json``, as the JAX package
names it. A cell that fails is listed, and the command exits non-zero
after the rest have run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from ..configs.base import ARCH_IDS, SHAPES, ModelConfig, ShapeSpec, get_config
from ..distributed import ctx
from ..distributed.sharding import (param_shardings, param_specs,
                                    place_cache)
from ..models import build_model
from ..models.model import batch_spec
from ..optim import adamw, constant
from ..train.step import (make_decode_step, make_prefill_step,
                          make_train_step)
from . import roofline as RL
from .mesh import HW
from .op_cost import fake_mesh, step_cost

__all__ = ["SKIPS", "MESHES", "cells", "meta_params", "active_params",
           "model_flops", "bytes_per_card", "activation_axes", "trace_step",
           "build_traced", "run_cell", "fmt_row", "main"]

# long_500k runs only for sub-quadratic archs
SKIPS = {(a, "long_500k") for a in ARCH_IDS} - {
    ("mamba2_2p7b", "long_500k"), ("jamba15_large", "long_500k")}

#: mesh tag -> {axis: size}
MESHES = {"32x8": {"data": 32, "model": 8},
          "2x32x8": {"pod": 2, "data": 32, "model": 8}}


def cells(include_skipped: bool = False):
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if (arch, shape) in SKIPS and not include_skipped:
                continue
            yield arch, shape


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: shapes only."""

    @property
    def device(self):
        return torch.device("meta")


def meta_params(cfg: ModelConfig):
    """The model's ``Params`` on the meta device (nothing allocated)."""
    return build_model(cfg, device="meta").init(_MetaGenerator())


def active_params(params, cfg: ModelConfig) -> int:
    """N for MODEL_FLOPS = 6*N*D: active (MoE top-k of E) non-embedding."""
    total = 0
    for name, p in params.named_parameters():
        n = int(p.numel())
        last = name.split(".")[-1]
        if last in ("tok", "head"):
            continue                       # 6ND convention: no embeddings
        if last in ("ewg", "ewu", "ewd") and cfg.moe:
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total


def model_flops(cfg: ModelConfig, params, shape: ShapeSpec) -> float:
    n = active_params(params, cfg)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n * tokens


def bytes_per_card(params, axes: dict, strategy: str = "tp") -> dict:
    """{param name: (elements, itemsize)} on the fullest card under
    ``param_specs`` on a mesh of ``axes`` ({axis: size})."""
    specs = param_specs(params, strategy=strategy)
    out = {}
    for name, p in params.named_parameters():
        n = 1
        for dim, ax in zip(p.shape, specs[name] or (None,) * p.ndim):
            shards = 1
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                shards *= axes.get(a, 1)
            n *= math.ceil(dim / shards)
        out[name] = (n, p.element_size())
    return out


def activation_axes(axes: dict, global_batch: int, strategy: str = "tp"):
    """JAX's choice of (batch axes, sequence axes, data size) for a cell
    on a mesh of ``axes``: the batch over the data-like axes when it
    divides them ('model' too under fsdp), else under fsdp over the data
    axes with the sequence over 'model', else replicated."""
    data = tuple(a for a in ("pod", "data") if a in axes)
    dsize = math.prod(axes[a] for a in data)
    one = lambda t: t if len(t) > 1 else (t[0] if t else None)  # noqa: E731
    if strategy == "fsdp":
        full = data + ("model",)
        if global_batch % (dsize * axes.get("model", 1)) == 0:
            return one(full), None, dsize
        if global_batch % dsize == 0:
            return one(data), "model", dsize
        return None, None, dsize
    return (one(data) if global_batch % dsize == 0 else None), None, dsize


def _fake_batch(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return {k: torch.zeros(s, dtype=d) for k, (s, d) in
            batch_spec(cfg, shape.seq_len, shape.global_batch,
                       shape.kind).items()}


def trace_step(cfg: ModelConfig, shape: ShapeSpec, axes: dict,
               remat: str = "full", strategy: str = "tp"):
    """Trace one step of ``cfg`` at ``shape`` on a fake mesh of ``axes``
    ({axis: size}) and count rank 0: ``(op_cost.Cost, peak live bytes,
    seconds)``. The state (params, moments or cache, batch) is placed
    before the count starts; the peak counts it."""
    baxes, saxes, dsize = activation_axes(axes, shape.global_batch, strategy)
    prev = (ctx.get_batch_axes(), ctx.get_seq_axes(), ctx.get_data_size())
    ctx.set_batch_axes(baxes)
    ctx.set_seq_axes(saxes)
    ctx.set_data_size(dsize)
    t0 = time.time()
    try:
        with fake_mesh(axes) as mesh:
            bundle = build_model(cfg, remat=remat, device="cpu")
            params = param_shardings(
                mesh, bundle.init(torch.Generator("cpu").manual_seed(0)),
                strategy=strategy)
            batch = _fake_batch(cfg, shape)
            if shape.kind == "train":
                opt = adamw(constant(1e-4))
                state = opt.init(params)
                step = make_train_step(bundle, opt, mesh=mesh,
                                       strategy=strategy)
                args = (params, state, batch)
            elif shape.kind == "prefill":
                step = make_prefill_step(bundle, mesh=mesh,
                                         strategy=strategy)
                args = (params, batch)
            else:
                from torch.distributed.tensor.experimental import (
                    implicit_replication)
                with implicit_replication():
                    cache = place_cache(bundle.init_cache(
                        params, shape.global_batch, shape.seq_len), mesh)
                step = make_decode_step(bundle, mesh=mesh)
                args = (params, batch["tokens"], cache)
            cost, peak, _ = step_cost(step, *args, mesh=mesh)
    finally:
        ctx.set_batch_axes(prev[0])
        ctx.set_seq_axes(prev[1])
        ctx.set_data_size(prev[2])
    return cost, peak, time.time() - t0


def build_traced(arch: str, shape_name: str, multi_pod: bool = False,
                 remat: str = "full", strategy: str = "tp",
                 moe_cap: float = 0.0, attn_chunk: int = 0):
    """The counterpart of JAX's ``build_lowered``: the cell's config (with
    JAX's ``moe_cap`` and ``attn_chunk`` replacements) traced on the
    production mesh. Returns ``(cost, peak, axes, model_flops, cfg,
    seconds)``."""
    cfg = get_config(arch)
    if moe_cap and cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_per_choice=moe_cap))
    if attn_chunk:
        cfg = dataclasses.replace(cfg, attn_chunk=attn_chunk)
    shape = SHAPES[shape_name]
    axes = MESHES["2x32x8" if multi_pod else "32x8"]
    cost, peak, secs = trace_step(cfg, shape, axes, remat, strategy)
    mf = model_flops(cfg, meta_params(cfg), shape)
    return cost, peak, axes, mf, cfg, secs


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             outdir: str = "", tag: str = "", strategy: str = "tp",
             remat: str = "full", moe_cap: float = 0.0,
             attn_chunk: int = 0) -> dict:
    cost, peak, axes, mf, cfg, secs = build_traced(
        arch, shape_name, multi_pod, remat=remat, strategy=strategy,
        moe_cap=moe_cap, attn_chunk=attn_chunk)
    mesh_tag = "2x32x8" if multi_pod else "32x8"
    chips = math.prod(axes.values())
    params = meta_params(cfg)
    per = bytes_per_card(params, axes, strategy)
    param_b = sum(n * s for n, s in per.values())
    train = SHAPES[shape_name].kind == "train"
    grad_b = param_b if train else 0
    moment_b = 2 * 4 * sum(n for n, _ in per.values()) if train else 0
    state_b = param_b + grad_b + moment_b
    rl = RL.analyze(cost, peak, chips, model_flops=mf)
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "tag": tag,
           "strategy": strategy, "remat": remat,
           "t_trace_s": round(secs, 1),
           "params": RL.count_params(params),
           "active_params": active_params(params, cfg),
           "param_bytes_per_chip": param_b,
           "grad_bytes_per_chip": grad_b,
           "moment_bytes_per_chip": moment_b,
           "state_bytes_per_chip": state_b,
           "fits_hbm": peak <= HW.HBM_BYTES,
           **rl.row()}
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        name = f"{arch}_{shape_name}_{mesh_tag}{tag}.json"
        with open(os.path.join(outdir, name), "w") as f:
            json.dump(row, f, indent=1)
    return row


def fmt_row(row: dict) -> str:
    mem = row.get("peak_memory_per_chip")
    mem_s = f"{mem / 2**30:6.1f}GiB" if mem else "   n/a  "
    return (f"{row['arch']:22s} {row['shape']:12s} {row['mesh']:8s} "
            f"tc={row['t_compute_s']:9.3e} tm={row['t_memory_s']:9.3e} "
            f"tl={row['t_collective_s']:9.3e} bound={row['bottleneck']:10s} "
            f"mem={mem_s} useful={row.get('useful_ratio') or 0:6.3f} "
            f"mfu_bound={row.get('mfu_bound') or 0:5.3f} "
            f"[trace {row['t_trace_s']:.0f}s]")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--moe-cap", type=float, default=0.0)
    ap.add_argument("--attn-chunk", type=int, default=0)
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    todo = (list(cells()) if args.all else
            [(args.arch or "qwen3_32b", args.shape or "train_4k")])
    mesh_tag = "2x32x8" if args.multi_pod else "32x8"
    rows, failures = [], []
    for arch, shape in todo:
        path = os.path.join(args.out,
                            f"{arch}_{shape}_{mesh_tag}{args.tag}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"skip {arch} {shape} (exists)", file=sys.stderr,
                  flush=True)
            continue
        try:
            row = run_cell(arch, shape, args.multi_pod, args.out, args.tag,
                           args.strategy, remat=args.remat,
                           moe_cap=args.moe_cap, attn_chunk=args.attn_chunk)
        except Exception as e:  # noqa: BLE001  listed; the rest still run
            failures.append((arch, shape, repr(e)))
            print(f"FAIL {arch} {shape}: {e!r}", file=sys.stderr,
                  flush=True)
            traceback.print_exc()
            continue
        print(json.dumps(row), flush=True)
        print(fmt_row(row), file=sys.stderr, flush=True)
        rows.append(row)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    return rows


if __name__ == "__main__":
    main()
