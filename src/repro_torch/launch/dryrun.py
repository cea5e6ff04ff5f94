"""Pod-scale dry run of the LM scaffold by counting shapes; port of
``repro.launch.dryrun``.

The JAX package compiles every (arch x shape x mesh) cell ahead of time
and reads XLA's memory and cost analyses and the partitioned HLO. The
port has no HLO. It builds each model on the meta device (shapes only,
nothing allocated) and counts, per cell:

  * ``params``: every parameter's elements (``roofline.count_params``);
  * ``active_params`` and ``model_flops``: the non-embedding params with
    a MoE layer's experts scaled to top-k of E, and 6 (train) or 2
    (prefill, decode) x active params x tokens — the JAX package's
    functions, giving its numbers;
  * the bytes each card holds of the params, and for a train cell of the
    gradients (the params' dtype) and the two fp32 AdamW moments, laid
    out by ``param_specs`` on the mesh (a dim split over n shards holds
    ceil(dim / n) on the fullest card), and whether they fit the card's
    ``HW.HBM_BYTES``;
  * the compute bound ``t_compute_s`` = model_flops / (cards x the bf16
    tensor-core peak).

It does not count activations (nor decode caches) or collective bytes:
those need the compiled program, which only a run shows. Their fields
are null and ``not_counted`` says why.

Meshes: 256 cards as (data 32, model 8), 512 as (pod 2, data 32,
model 8). The model axis is one NVLink node of 8 H100s (TP within a
node); the TPU pod the JAX package targets had (16, 16).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_32b \
      --shape train_4k [--multi-pod] [--strategy tp|fsdp] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Each row is printed as JSON and written to
``DIR/<arch>_<shape>_<mesh><tag>.json``, as the JAX package names it.
"""
from __future__ import annotations

import argparse
import json
import math
import os

import torch

from ..configs.base import ARCH_IDS, SHAPES, ModelConfig, ShapeSpec, get_config
from ..distributed.sharding import param_specs
from ..models import build_model
from . import roofline as RL
from .mesh import HW

__all__ = ["SKIPS", "MESHES", "cells", "meta_params", "active_params",
           "model_flops", "bytes_per_card", "run_cell", "main"]

# long_500k runs only for sub-quadratic archs
SKIPS = {(a, "long_500k") for a in ARCH_IDS} - {
    ("mamba2_2p7b", "long_500k"), ("jamba15_large", "long_500k")}

#: mesh tag -> {axis: size}
MESHES = {"32x8": {"data": 32, "model": 8},
          "2x32x8": {"pod": 2, "data": 32, "model": 8}}

NOT_COUNTED = {
    "activations": "activations and decode caches depend on the compiled "
                   "program (remat, fusion, buffers); shapes alone do not "
                   "give them",
    "collective_bytes": "the collectives are chosen by DTensor's sharding "
                        "propagation at run time; there is no partitioned "
                        "program to read them from",
}


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


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             outdir: str = "", tag: str = "", strategy: str = "tp") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_tag = "2x32x8" if multi_pod else "32x8"
    axes = MESHES[mesh_tag]
    chips = math.prod(axes.values())
    params = meta_params(cfg)
    mf = model_flops(cfg, params, shape)
    per = bytes_per_card(params, axes, strategy)
    param_b = sum(n * s for n, s in per.values())
    train = shape.kind == "train"
    grad_b = param_b if train else 0
    moment_b = 2 * 4 * sum(n for n, _ in per.values()) if train else 0
    state_b = param_b + grad_b + moment_b
    t_compute = mf / (chips * HW.PEAK_FLOPS_BF16)
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "tag": tag,
           "strategy": strategy, "chips": chips,
           "params": RL.count_params(params),
           "active_params": active_params(params, cfg),
           "model_flops": mf,
           "param_bytes_per_chip": param_b,
           "grad_bytes_per_chip": grad_b,
           "moment_bytes_per_chip": moment_b,
           "state_bytes_per_chip": state_b,
           "fits_hbm": state_b <= HW.HBM_BYTES,
           "t_compute_s": t_compute,
           "t_memory_s": None, "t_collective_s": None,
           "bottleneck": None,
           "coll_bytes_per_chip": None,
           "peak_memory_per_chip": None,
           "not_counted": NOT_COUNTED}
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        name = f"{arch}_{shape_name}_{mesh_tag}{tag}.json"
        with open(os.path.join(outdir, name), "w") as f:
            json.dump(row, f, indent=1)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    todo = (list(cells()) if args.all else
            [(args.arch or "qwen3_32b", args.shape or "train_4k")])
    rows = []
    for arch, shape in todo:
        row = run_cell(arch, shape, args.multi_pod, args.out, args.tag,
                       args.strategy)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
