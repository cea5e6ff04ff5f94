"""The card side of tests/test_torch_gpu_sharded.py: the reduced
configs' sharded steps on ``nccl`` meshes (one process a card, joined by
a ``FileStore``) against the plain step on one card. Imports no JAX."""
import dataclasses
import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_batch
from repro_torch.distributed.sharding import param_shardings
from repro_torch.models import build_model
from repro_torch.optim import adamw, constant
from repro_torch.train import make_train_step

LR = 1e-3


def steps(arch, device, mesh=None, n=2):
    """[(loss, grad norm)] x n and the params after, whole, on the host."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32", attn_chunk=8)
    m = build_model(cfg, device=device)
    params = m.init(torch.Generator(device).manual_seed(0))
    if mesh is not None:
        param_shardings(mesh, params)
    opt = adamw(constant(LR))
    step, st, mets = make_train_step(m, opt, mesh=mesh), opt.init(params), []
    for i in range(n):
        params, st, met = step(params, st, make_batch(cfg, DataConfig(4, 16),
                                                       i))
        mets.append((float(met["loss"]), float(met["grad_norm"])))
    whole = {k: (p.full_tensor() if isinstance(p, DTensor) else p)
             .detach().cpu() for k, p in params.named_parameters()}
    return mets, whole


def run(rank, world, store, shape, archs, out):
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank),
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cuda", shape,
                                mesh_dim_names=("data", "model"))
        res = {a: steps(a, f"cuda:{rank}", mesh) for a in archs}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(res, out)
