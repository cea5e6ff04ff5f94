"""AdamW from scratch; port of ``repro.optim.adamw``.

bf16 params + fp32 moments; global-norm clipping; decoupled weight decay
(skipped for 1-D leaves: norms/biases). A functional-looking init/update
pair over a ``Params`` module, with the JAX package's arithmetic:

  * ``init(params)`` -> ``{"m": {name: fp32}, "v": {name: fp32},
    "step": int32}``, keyed by the module's parameter names;
  * ``update(grads, state, params)`` -> ``(params, state, metrics)``:
    ``grads`` maps each parameter name to its gradient (any dtype). The
    params and moments are updated in place, leaf by leaf, so an fp32
    copy of every gradient never exists at once: the global norm is a sum
    of per-leaf fp32 sums of squares. The new param is computed in fp32
    and cast to its dtype. Metrics: ``grad_norm`` (before clipping) and
    ``lr``.

On a mesh the params are DTensors (``distributed.sharding``): the
moments take each param's placements (``moment_specs``, the params'
own), a gradient is first laid out as its param is (the backward hands
some back as partial sums), the global norm sums each rank's squares and
all-reduces them once per distinct layout, so every rank holds the same
scalar, and the update itself runs on the local shards.

Weight decay follows the rank a leaf has in the JAX package's layout,
which stacks the layers of a list along a leading axis: a leaf inside an
``nn.ModuleList`` (a name with an integer part, ``layers.3.ln1``) counts
one more dimension, so per-layer norm scales and biases are decayed and
the final norm is not, as there.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["AdamW", "adamw", "decays", "like_param"]


class AdamW(NamedTuple):
    init: Callable
    update: Callable


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether leaf ``name`` is decayed: rank >= 2 in the JAX layout."""
    stacked = any(part.isdigit() for part in name.split("."))
    return p.ndim + stacked >= 2


def like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` laid out as its param ``p`` (a no-op off a mesh)."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _sumsq(grads: list) -> torch.Tensor:
    """The global sum of squares of ``grads`` (each laid out as its
    param), in fp32, summed leaf by leaf in order as on one device. A
    DTensor leaf's square sum is its shard's, all-reduced over the mesh
    dims that shard it: one collective per distinct (mesh, placements),
    over the vector of that layout's leaves."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    parts = [g.to_local().float().square().sum() if isinstance(g, DTensor)
             else g.float().square().sum() for g in grads]
    groups = {}
    for i, g in enumerate(grads):
        if isinstance(g, DTensor):
            groups.setdefault((g.device_mesh, tuple(g.placements)),
                              []).append(i)
    for (mesh, pls), idx in groups.items():
        red = tuple(Partial() if isinstance(p, Shard) else Replicate()
                    for p in pls)
        whole = DTensor.from_local(torch.stack([parts[i] for i in idx]),
                                   mesh, red, run_check=False).full_tensor()
        for j, i in enumerate(idx):
            parts[i] = whole[j]
    return sum(parts)


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0) -> AdamW:
    lr_fn = lr if callable(lr) else (
        lambda step: torch.full((), lr, dtype=torch.float32,
                                device=step.device))

    def init(params):
        named = list(params.named_parameters())
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": {n: zeros(p) for n, p in named},
                "v": {n: zeros(p) for n, p in named},
                "step": torch.zeros((), dtype=torch.int32,
                                    device=named[0][1].device)}

    @torch.no_grad()
    def update(grads, state, params):
        named = list(params.named_parameters())
        grads = {n: like_param(grads[n], p) for n, p in named}
        gnorm = torch.sqrt(_sumsq([grads[n] for n, _ in named]))
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        for n, p in named:                    # fp32 temporaries of one leaf
            g = _local(grads[n]).float() * scale
            m, v = _local(state["m"][n]), _local(state["v"][n])
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_(((1 - b2) * g).mul_(g))
            del g
            u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            pl = _local(p)
            p32 = pl.float()
            if decays(n, p):                  # decoupled WD, matrices only
                u.add_(weight_decay * p32)
            pl.copy_(p32 - u.mul_(lr_t))
        return params, {"m": state["m"], "v": state["v"], "step": step}, {
            "grad_norm": gnorm, "lr": lr_t}

    return AdamW(init, update)
