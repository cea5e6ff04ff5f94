"""The multi-process side of tests/test_torch_sharded_train.py: one
``gloo`` process a rank, joined by a ``FileStore`` (no TCP port), on CPU
meshes. Imports no JAX: the JAX references are computed in the test
process and handed over as numpy. ``run`` executes every case in one
spawn and rank 0 pickles what it saw; each case is a function of its
own below.

Cases:
  * parity: per mesh shape and architecture (reduced, float32), the loss
    and grad norm of 2 sharded AdamW steps, the first step's gradients
    laid out as their params and made whole, and the params after;
  * jax: the sharded loss and gradients on JAX's weights and batch;
  * accum: one accumulated step over 2 microbatches on (2, 2);
  * elastic: a step on (2, 2), a checkpoint, the next step there; the
    same next step after restoring the checkpoint onto a (2, 1) mesh of
    ranks 0-1, and after ``elastic_rescale`` of the live (2, 2) state
    (restored in place) onto it;
  * error feedback and the compressed step on a 'data' mesh of ranks 0-1;
  * collectives: one train step of each architecture on (2, 2) under
    ``op_cost.CollectiveCounter`` (counts and result bytes by kind) and
    torch's ``CommDebugMode`` (counts), for holding the fake-process-group
    trace to;
  * serve: the prefill's logits and 6 decode steps' logits (tokens fed
    from the batch, cache laid out by ``cache_specs``) on (2, 2) and
    (1, 4), whole.
"""
import dataclasses
import datetime
import os
import pickle

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import DataConfig, make_batch
from repro_torch.distributed.compress import (compressed_grads, init_ef,
                                              make_compressed_train_step)
from repro_torch.distributed.sharding import (param_shardings, place_cache,
                                              state_shardings)
from repro_torch.launch.op_cost import CollectiveCounter
from repro_torch.models import build_model
from repro_torch.optim import adamw, constant
from repro_torch.optim.adamw import like_param
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import make_accum_train_step, make_train_step
from repro_torch.train.step import make_decode_step, make_prefill_step
from repro_torch.train.loop import elastic_rescale
from repro_torch.train.step import _value_and_grad, to_device

MESHES = [(2, 2), (1, 4), (4, 1)]
SERVE_MESHES = [(2, 2), (1, 4)]
DECODE_STEPS = 6
ARCHS = ["qwen3_32b", "qwen3_moe_235b", "mamba2_2p7b"]
LR = 1e-3


def cfg32(arch, attn_chunk=8):
    """The reduced config in float32; attention chunks of 8, so that the
    16-token batches run the blockwise forward and flash backward."""
    return dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32", attn_chunk=attn_chunk)


def batches(arch, n=2):
    return [make_batch(cfg32(arch), DataConfig(4, 16), s) for s in range(n)]


def init(cfg, mesh=None):
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator("cpu").manual_seed(0))
    if mesh is not None:
        param_shardings(mesh, params)
    return m, params


def _whole(t):
    from torch.distributed.tensor import DTensor
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy().copy()


def first_grads(m, params, batch, mesh=None):
    loss, grads = _value_and_grad(m, params, to_device(batch, "cpu"), mesh)
    named = dict(params.named_parameters())
    return float(loss), {n: _whole(like_param(g, named[n]))
                         for n, g in grads.items()}


def two_steps(arch, mesh=None):
    """(first-step grads, [(loss, grad_norm)] x 2, final params)."""
    m, params = init(cfg32(arch), mesh)
    bs = batches(arch)
    _, grads = first_grads(m, params, bs[0], mesh)
    opt = adamw(constant(LR))
    st = opt.init(params)
    step = make_train_step(m, opt, mesh=mesh)
    mets = []
    for b in bs:
        params, st, met = step(params, st, b)
        mets.append((float(met["loss"]), float(met["grad_norm"])))
    return grads, mets, {n: _whole(p) for n, p in params.named_parameters()}


def collectives(arch, mesh):
    """One train step of the reduced config (float32) under
    CollectiveCounter inside torch's CommDebugMode: (counts, result bytes)
    by kind, and CommDebugMode's counts by functional collective."""
    from torch.distributed.tensor.debug import CommDebugMode
    m, params = init(cfg32(arch), mesh)
    opt = adamw(constant(LR))
    st = opt.init(params)
    with CommDebugMode() as cdm, CollectiveCounter(mesh) as cc:
        make_train_step(m, opt, mesh=mesh)(params, st, batches(arch, 1)[0])
    comm = {str(k).split(".")[-1]: v for k, v in cdm.get_comm_counts().items()}
    return cc.counts, cc.raw, comm


def serve_steps(arch, mesh=None):
    """The prefill's last logits, then DECODE_STEPS decode steps from an
    empty cache of 16 positions fed the batch's tokens: [logits] whole."""
    cfg = cfg32(arch)
    m, params = init(cfg, mesh)
    tokens = torch.as_tensor(batches(arch, 1)[0]["tokens"])
    out = [_whole(make_prefill_step(m, mesh=mesh)(params,
                                                  {"tokens": tokens}))]
    cache = m.init_cache(params, tokens.shape[0], 16)
    if mesh is not None:
        cache = place_cache(cache, mesh)
    decode = make_decode_step(m, mesh=mesh)
    for i in range(DECODE_STEPS):
        _, logits, cache = decode(params, tokens[:, i:i + 1], cache)
        out.append(_whole(logits))
    return out


def accum_step(mesh=None):
    """One make_accum_train_step over 2 microbatches of the reduced qwen3
    (float32): (loss, grad norm, params)."""
    m, params = init(cfg32("qwen3_32b"), mesh)
    opt = adamw(constant(LR))
    b = batches("qwen3_32b", 1)[0]
    micro = {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:])
             for k, v in b.items()}
    params, _, met = make_accum_train_step(m, opt, 2, mesh=mesh)(
        params, opt.init(params), micro)
    return (float(met["loss"]), float(met["grad_norm"]),
            {n: _whole(p) for n, p in params.named_parameters()})


def _jax_case(mesh, jparams, jbatch):
    cfg = cfg32("qwen3_32b", attn_chunk=1024)
    m = build_model(cfg, remat="none", device="cpu")
    params = param_shardings(mesh, lm_params_from_jax(jparams, cfg))
    return first_grads(m, params, jbatch, mesh)


def _elastic(rank, mesh, sub, ckpt_dir):
    cfg = cfg32("qwen3_32b")
    b0, b1 = batches("qwen3_32b")
    opt = adamw(constant(LR))
    m, params = init(cfg, mesh)
    state = {"params": params, "opt": opt.init(params)}
    step = make_train_step(m, opt, mesh=mesh)
    p, o, _ = step(state["params"], state["opt"], b0)
    state = {"params": p, "opt": o}
    ckpt.save(ckpt_dir, 0, state)
    _, _, met = step(p, o, b1)
    out = {"ref": float(met["loss"])}
    sub_step = make_train_step(m, opt, mesh=sub)
    if rank < 2:                       # (a) restore onto the sub-mesh
        _, host = init(cfg)
        host = {"params": host, "opt": opt.init(host)}
        got = ckpt.restore(ckpt_dir, 0, host,
                           shardings=state_shardings(sub, host))
        _, _, met = sub_step(got["params"], got["opt"], b1)
        out["restore"] = float(met["loss"])
    state = ckpt.restore(ckpt_dir, 0, state)     # in place, on (2, 2)
    got = elastic_rescale(state, sub, state_shardings)
    assert (got is None) == (rank >= 2)
    if got is not None:                # (b) the live state rescaled
        _, _, met = sub_step(got["params"], got["opt"], b1)
        out["rescale"] = float(met["loss"])
    return out


def _compression(rank, dp, jparams, cbatch):
    if rank >= 2:
        return None
    group = dp.get_group("data")
    g = {"w": torch.full((64,), 0.001234, dtype=torch.float32)}
    ef = {"w": torch.zeros(64)}
    total = torch.zeros(64)
    for _ in range(50):
        gh, ef = compressed_grads(g, ef, group)
        total += gh["w"]
    cfg = cfg32("qwen3_32b", attn_chunk=1024)
    m = build_model(cfg, device="cpu")
    params = lm_params_from_jax(jparams, cfg)
    opt = adamw(constant(LR))
    step = make_compressed_train_step(m.loss, opt, dp)
    _, _, ef2, met = step(params, opt.init(params), init_ef(params), cbatch)
    return {"total": total.numpy(), "loss": float(met["loss"]),
            "ef_nonzero": any(bool(e.abs().max() > 0) for e in ef2.values())}


def run(rank, world, store, out, jparams, jbatch, cbatch):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    res = {}
    try:
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            for arch in ARCHS:
                res[("parity", arch, shape)] = two_steps(arch, mesh)
                if shape in SERVE_MESHES:
                    res[("serve", arch, shape)] = serve_steps(arch, mesh)
                if shape == (2, 2):
                    res[("collectives", arch)] = collectives(arch, mesh)
            if shape == (2, 2):
                res["jax"] = _jax_case(mesh, jparams, jbatch)
                res["accum"] = accum_step(mesh)
                sub = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                                 mesh_dim_names=("data", "model"))
                res["elastic"] = _elastic(rank, mesh, sub,
                                          os.path.dirname(out) + "/ckpt")
        dp = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("data",))
        res["compression"] = _compression(rank, dp, jparams, cbatch)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
