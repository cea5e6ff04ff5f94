"""Train / prefill / decode step builders; port of ``repro.train.step``.

``params`` is the bundle's ``Params`` module and ``opt_state`` AdamW's
state; a step updates both in place (under ``torch.no_grad``) and returns
the same objects. A batch is a dict of numpy arrays (or tensors): the
step moves it to the bundle's device.
"""
from __future__ import annotations

import torch

from ..models.model import ModelBundle
from ..optim.adamw import AdamW

__all__ = ["make_train_step", "make_accum_train_step", "make_prefill_step",
           "make_decode_step", "to_device"]


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _value_and_grad(bundle: ModelBundle, params, batch):
    named = list(params.named_parameters())
    loss = bundle.loss(params, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def make_train_step(bundle: ModelBundle, opt: AdamW):
    def train_step(params, opt_state, batch):
        loss, grads = _value_and_grad(bundle, params,
                                      to_device(batch, bundle.device))
        params, opt_state, metrics = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **metrics}
    return train_step


def make_accum_train_step(bundle: ModelBundle, opt: AdamW, accum: int):
    """Gradient accumulation over ``accum`` microbatches (the batch's
    leading dim): fp32 gradient sums, divided by ``accum`` once, and the
    mean of the microbatch losses."""
    def train_step(params, opt_state, batch):
        batch = to_device(batch, bundle.device)
        gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                       device=bundle.device)
        for i in range(accum):
            loss, grads = _value_and_grad(
                bundle, params, {k: v[i] for k, v in batch.items()})
            if gsum is None:
                gsum = {n: g.float() for n, g in grads.items()}
            else:
                for n, g in grads.items():
                    gsum[n] += g.float()
            lsum = lsum + loss
            del grads
        for g in gsum.values():
            g /= accum
        params, opt_state, metrics = opt.update(gsum, opt_state, params)
        return params, opt_state, {"loss": lsum / accum, **metrics}
    return train_step


def make_prefill_step(bundle: ModelBundle):
    def prefill_step(params, batch):
        return bundle.prefill(params, batch)
    return prefill_step


def make_decode_step(bundle: ModelBundle):
    def decode_step(params, tokens, cache):
        logits, cache = bundle.decode(params, tokens, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache
    return decode_step
