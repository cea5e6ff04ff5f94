"""int8 gradient compression with error feedback for the data-parallel
axis; port of ``repro.distributed.compress``.

Scheme (1-bit-Adam-family, simplified to int8), per gradient leaf:
  1. g_corr = g_local + ef                    (error feedback carry-in)
  2. scale  = all_reduce_max(|g_corr|) / 127  (one scalar collective)
  3. q      = clip(round(g_corr / scale), -127, 127)  int8
  4. g_hat  = all_reduce_sum(int32(q)) * scale / n
  5. ef'    = g_corr - q * scale              (local quantization residual)

``torch.round`` rounds half to even, as ``jnp.round`` does. The sum runs
over int32 copies of the int8 codes, so it is exact, and its result is
the same on every rank. Params, moments and the feedback are replicated
plain tensors in this path (pure data parallelism; the sharded path keeps
fp32 gradients); the batch is split over one mesh axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["init_ef", "compressed_grads", "make_compressed_train_step"]


def init_ef(params) -> dict:
    """Zero feedback, fp32, one per parameter name."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.named_parameters()}


def _compress_one(g, ef, group):
    g = g.float() + ef
    amax = g.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    n = dist.get_world_size(group)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    g_hat = total.float() * scale / n
    return g_hat, g - deq


def compressed_grads(grads: dict, ef: dict, group=None):
    """All-reduce int8-compressed grads with error feedback over
    ``group`` (a process group; None: the world). Returns (g_hat, ef),
    dicts keyed as ``grads``."""
    out = {n: _compress_one(g, ef[n], group) for n, g in grads.items()}
    return ({n: t[0] for n, t in out.items()},
            {n: t[1] for n, t in out.items()})


def make_compressed_train_step(loss_fn, optimizer, mesh, axis: str = "data"):
    """Pure-DP train step with int8 grad all-reduce.

    ``step(params, opt_state, ef, batch) -> (params, opt_state, ef,
    metrics)``: params/opt_state/ef are replicated plain tensors; the
    global batch (the same on every rank) is split over ``axis`` and this
    rank computes on its rows; the loss is averaged over ``axis``.
    """
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)

    def step(params, opt_state, ef, batch):
        named = list(params.named_parameters())
        dev = named[0][1].device
        rows = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            b = v.shape[0] // n
            rows[k] = v[idx * b:(idx + 1) * b].to(dev)
        loss = loss_fn(params, rows)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        loss = loss.detach().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        loss = loss / n
        g_hat, ef = compressed_grads(
            {name: g for (name, _), g in zip(named, grads)}, ef, group)
        params, opt_state, metrics = optimizer.update(g_hat, opt_state,
                                                      params)
        return params, opt_state, ef, {"loss": loss, **metrics}

    return step
