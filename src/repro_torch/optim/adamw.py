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

Weight decay follows the rank a leaf has in the JAX package's layout,
which stacks the layers of a list along a leading axis: a leaf inside an
``nn.ModuleList`` (a name with an integer part, ``layers.3.ln1``) counts
one more dimension, so per-layer norm scales and biases are decayed and
the final norm is not, as there.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["AdamW", "adamw", "decays"]


class AdamW(NamedTuple):
    init: Callable
    update: Callable


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether leaf ``name`` is decayed: rank >= 2 in the JAX layout."""
    stacked = any(part.isdigit() for part in name.split("."))
    return p.ndim + stacked >= 2


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0) -> AdamW:
    lr_fn = lr if callable(lr) else (
        lambda step: torch.full((), lr, dtype=torch.float32,
                                device=step.device))

    def init(params):
        named = list(params.named_parameters())
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": {n: zeros(p) for n, p in named},
                "v": {n: zeros(p) for n, p in named},
                "step": torch.zeros((), dtype=torch.int32,
                                    device=named[0][1].device)}

    @torch.no_grad()
    def update(grads, state, params):
        named = list(params.named_parameters())
        gnorm = torch.sqrt(sum(grads[n].float().square().sum()
                               for n, _ in named))
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        for n, p in named:                    # fp32 temporaries of one leaf
            g = grads[n].float() * scale
            m, v = state["m"][n], state["v"][n]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_(((1 - b2) * g).mul_(g))
            del g
            u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            p32 = p.float()
            if decays(n, p):                  # decoupled WD, matrices only
                u.add_(weight_decay * p32)
            p.copy_(p32 - u.mul_(lr_t))
        return params, {"m": state["m"], "v": state["v"], "step": step}, {
            "grad_norm": gnorm, "lr": lr_t}

    return AdamW(init, update)
