"""Train / prefill / decode step builders; port of ``repro.train.step``.

``params`` is the bundle's ``Params`` module and ``opt_state`` AdamW's
state; a step updates both in place (under ``torch.no_grad``) and returns
the same objects. A batch is a dict of numpy arrays (or tensors): the
step moves it to the bundle's device.

With a ``mesh`` (a ``DeviceMesh`` with axes ('data', 'model'), and
'pod' where there is one) the params are DTensors
(``distributed.sharding.param_shardings``) and so is AdamW's state.
Every rank builds the same global batch (the synthetic pipeline is a
pure function of the step) and keeps its own rows by ``batch_specs``;
the model runs on DTensors under the activation context
(``distributed.ctx``: batch over the data axes when the batch divides
them) with plain tensors taken as replicated. The loss is made whole on
every rank before the backward, and AdamW lays each gradient out as its
param.
"""
from __future__ import annotations

import contextlib

import torch

from ..distributed import ctx
from ..distributed.sharding import axis_size, batch_specs, place
from ..models.model import ModelBundle
from ..optim.adamw import AdamW, like_param

__all__ = ["make_train_step", "make_accum_train_step", "make_prefill_step",
           "make_decode_step", "to_device", "on_mesh"]


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _place_batch(batch: dict, mesh, strategy: str = "tp") -> dict:
    specs = batch_specs(batch, mesh, strategy)
    return {k: place(v, mesh, specs[k]) for k, v in batch.items()}


@contextlib.contextmanager
def on_mesh(mesh, batch: dict, strategy: str = "tp"):
    """The activation context of a step over ``batch`` (already placed) on
    ``mesh``: the mesh, the batch axes when the batch is sharded, the data
    size, and plain tensors taken as replicated. Restores the previous
    context after."""
    from torch.distributed.tensor.experimental import implicit_replication
    spec = next(iter(batch_specs(batch, mesh, strategy).values()))
    axes = spec[0] if spec else None
    prev = (ctx.get_mesh(), ctx.get_batch_axes(), ctx.get_data_size())
    ctx.set_mesh(mesh)
    ctx.set_batch_axes(axes)
    ctx.set_data_size(axis_size(mesh, axes) if axes is not None else None)
    try:
        with implicit_replication():
            yield
    finally:
        ctx.set_mesh(prev[0])
        ctx.set_batch_axes(prev[1])
        ctx.set_data_size(prev[2])


def _value_and_grad(bundle: ModelBundle, params, batch, mesh=None,
                    strategy: str = "tp"):
    named = list(params.named_parameters())
    if mesh is None:
        loss = bundle.loss(params, batch)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        return loss.detach(), {n: g for (n, _), g in zip(named, grads)}
    batch = _place_batch(batch, mesh, strategy)
    with on_mesh(mesh, batch, strategy):
        loss = bundle.loss(params, batch).full_tensor()
        grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def make_train_step(bundle: ModelBundle, opt: AdamW, mesh=None,
                    strategy: str = "tp"):
    """One AdamW step. On a ``mesh`` the batch is laid out by
    ``batch_specs(strategy=)``: over the data axes ('tp'), or over them
    and 'model' ('fsdp')."""
    def train_step(params, opt_state, batch):
        loss, grads = _value_and_grad(bundle, params,
                                      to_device(batch, bundle.device), mesh,
                                      strategy)
        params, opt_state, metrics = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **metrics}
    return train_step


def make_accum_train_step(bundle: ModelBundle, opt: AdamW, accum: int,
                          mesh=None):
    """Gradient accumulation over ``accum`` microbatches (the batch's
    leading dim): fp32 gradient sums, divided by ``accum`` once, and the
    mean of the microbatch losses. On a mesh each microbatch is placed as
    a batch of its own, and each gradient is laid out as its param before
    it is summed."""
    def train_step(params, opt_state, batch):
        batch = to_device(batch, bundle.device)
        named = dict(params.named_parameters())
        gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                       device=bundle.device)
        for i in range(accum):
            loss, grads = _value_and_grad(
                bundle, params, {k: v[i] for k, v in batch.items()}, mesh)
            if gsum is None:
                gsum = {n: like_param(g, named[n]).float()
                        for n, g in grads.items()}
            else:                        # one fp32 temporary at a time
                for n, g in grads.items():
                    gsum[n] += like_param(g, named[n]).float()
            lsum = lsum + loss
            del grads
        for g in gsum.values():
            g /= accum
        params, opt_state, metrics = opt.update(gsum, opt_state, params)
        return params, opt_state, {"loss": lsum / accum, **metrics}
    return train_step


def make_prefill_step(bundle: ModelBundle, mesh=None, strategy: str = "tp"):
    """The prefill; on a ``mesh`` the batch is placed by ``batch_specs``
    and the model runs under the activation context, as in the train
    step."""
    def prefill_step(params, batch):
        if mesh is None:
            return bundle.prefill(params, batch)
        batch = _place_batch(to_device(batch, bundle.device), mesh,
                             strategy)
        with on_mesh(mesh, batch, strategy):
            return bundle.prefill(params, batch)
    return prefill_step


def make_decode_step(bundle: ModelBundle, mesh=None):
    """One decode step; on a ``mesh`` the tokens are placed as a batch
    (the cache already placed, by ``cache_specs``) under the activation
    context. The tokens follow the 'tp' rule under any strategy, as the
    cache does (the JAX package's dry run places them so too)."""
    def pick(last):
        return torch.argmax(last, dim=-1).to(torch.int32)

    def decode_step(params, tokens, cache):
        if mesh is None:
            logits, cache = bundle.decode(params, tokens, cache)
            return pick(logits[:, -1])[:, None], logits, cache
        batch = _place_batch({"tokens": tokens}, mesh)
        with on_mesh(mesh, batch):
            logits, cache = bundle.decode(params, batch["tokens"], cache)
            # each rank's rows made whole over the vocabulary, then local
            b = ctx.get_batch_axes()
            next_tok = ctx.local(pick, [(logits[:, -1], {0: b}, None)],
                                 [({0: b}, None)])
        return next_tok[:, None], logits, cache
    return decode_step
