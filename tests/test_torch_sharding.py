"""The port's sharding rules (repro_torch.distributed.sharding) on the CPU.

Mirrors the five tests of tests/test_sharding.py on the port (the last on
a (1, 1) ``gloo`` mesh of world 1 in this process), and holds the port's
specs to the JAX package's leaf for leaf: ``param_specs`` on every
architecture's reduced config, strategies 'tp' and 'fsdp', ``shard_data``
on and off; ``batch_specs`` and ``cache_specs`` on the same shapes and
mesh axes. A layer leaf's spec is JAX's without the leading ``None`` of
JAX's stacked repeat axis. Which JAX leaf a port parameter comes from is
read through ``convert.lm_params_from_jax``: each JAX leaf is filled with
its own index before the conversion.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.distributed.sharding import batch_specs as jbatch_specs
from repro.distributed.sharding import cache_specs as jcache_specs
from repro.distributed.sharding import param_specs as jparam_specs
from repro.models import build_model as jbuild_model

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_cache_from_jax, lm_params_from_jax
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              param_specs, placements)
from repro_torch.models import build_model

torch.set_num_threads(1)


class _Mesh:
    """The named sizes of a mesh: all the spec functions read."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())
        self.ndim = len(axes)

    def size(self, i=None):
        return self._sizes[i]


def _params(arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    return build_model(cfg, device="cpu").init(
        torch.Generator("cpu").manual_seed(0))


def test_param_spec_rules():
    specs = param_specs(_params("qwen3_moe_235b"))
    assert specs["embed.tok"] == ("model", "data")
    assert specs["layers.0.mixer.wq"] == ("data", "model")
    assert specs["layers.0.mixer.wo"] == ("model", "data")
    assert specs["layers.0.ff.ewg"] == ("model", "data", None)
    assert specs["layers.0.ff.ewd"] == ("model", None, "data")
    assert specs["layers.0.ln1"] == ()                  # norms replicated
    assert specs["layers.0.mixer.qn"] == ()


def test_param_spec_mamba():
    specs = param_specs(_params("mamba2_2p7b"))
    assert specs["layers.0.mixer.in_proj"] == ("data", "model")
    assert specs["layers.0.mixer.out_proj"] == ("model", "data")
    assert specs["layers.0.mixer.conv_w"] == (None, "model")
    assert specs["layers.0.mixer.A_log"] == ("model",)


def test_shard_data_off():
    specs = param_specs(_params("qwen3_32b"), shard_data=False)
    assert specs["layers.0.mixer.wq"] == (None, "model")


def test_cache_specs_kv_vs_seq():
    """kv-head dim sharded when divisible by the model axis, else the
    sequence dim (sequence-parallel cache)."""
    cache = [{"k": torch.empty(4, 64, 8, 16, device="meta"),
              "v": torch.empty(4, 64, 8, 16, device="meta"), "idx": 0}]
    specs = cache_specs(cache, _Mesh(data=1, model=1))
    assert specs[0]["k"][2] == "model"                  # kv divisible by 1
    assert specs[0]["idx"] is None
    specs = cache_specs(cache, _Mesh(data=2, model=16))
    assert specs[0]["k"] == ("data", "model", None, None)   # seq over model


def test_one_device_end_to_end_sharded_step(tmp_path):
    """The full sharded train step runs on a 1x1 mesh (the degenerate
    case of the production mesh) — catches spec/tree mismatches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.optim import adamw, constant
    from repro_torch.train import make_train_step

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config("qwen3_32b", reduced=True)
        m = build_model(cfg, device="cpu")
        params = param_shardings(mesh, m.init(
            torch.Generator("cpu").manual_seed(0)))
        opt = adamw(constant(1e-3))
        step = make_train_step(m, opt, mesh=mesh)
        b = {"tokens": np.ones((2, 16), np.int32),
             "labels": np.ones((2, 16), np.int32)}
        p2, o2, met = step(params, opt.init(params), b)
        assert bool(torch.isfinite(met["loss"]))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ leaf for leaf ----
def _jax_origin(arch):
    """(JAX shape tree, {port name: (JAX leaf path, JAX ndim)})."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    ids = jax.tree_util.tree_unflatten(
        tree, [np.full(s.shape, i, np.float32) for i, (_, s) in
               enumerate(flat)])
    origin = {}
    for n, t in lm_params_from_jax(ids, cfg).named_parameters():
        i = int(t.detach().reshape(-1)[0])
        origin[n] = (flat[i][0], len(flat[i][1].shape), tuple(t.shape))
    return shapes, origin


def _leaf(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", k))]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch):
    shapes, origin = _jax_origin(arch)
    params = {n: torch.empty(s, device="meta")
              for n, (_, _, s) in origin.items()}
    for kw in ({}, {"strategy": "fsdp"}, {"shard_data": False},
               {"strategy": "fsdp", "shard_data": False},
               {"data_axes": ("pod", "data")}):
        want = jparam_specs(shapes, **kw)
        got = param_specs(params, **kw)
        assert sorted(got) == sorted(origin)
        for n, (path, jdim, shape) in origin.items():
            spec = tuple(_leaf(want, path))
            if jdim == len(shape) + 1 and spec:      # stacked: drop R
                assert spec[0] is None, (n, spec)
                spec = spec[1:]
            assert got[n] == spec, (arch, kw, n, got[n], spec)


_MESHES = [dict(data=1, model=1), dict(data=4, model=2),
           dict(pod=2, data=2, model=2), dict(data=3, model=4)]


@pytest.mark.parametrize("axes", _MESHES, ids=lambda a: "x".join(
    map(str, a.values())))
def test_batch_and_cache_specs_equal_jax(axes):
    jmesh = AbstractMesh(tuple(axes.values()), tuple(axes))
    mesh = _Mesh(**axes)
    for strategy in ("tp", "fsdp"):
        for shape in [(8, 16), (6, 16, 64), (1, 32), (12,), ()]:
            want = jbatch_specs({"x": jax.ShapeDtypeStruct(shape, jnp.int32)},
                                jmesh, strategy=strategy)["x"].spec
            got = batch_specs({"x": torch.empty(shape, device="meta")},
                              mesh, strategy=strategy)["x"]
            assert got == tuple(want), (strategy, shape, got, want)
    for arch in ("qwen3_32b", "mamba2_2p7b", "jamba15_large",
                 "seamless_m4t_v2"):
        jcfg = jget_config(arch, reduced=True)
        cfg = get_config(arch, reduced=True)
        for batch, seq in ((4, 32), (3, 16), (12, 8)):
            jm = jbuild_model(jcfg)
            pshape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
            cshape = jax.eval_shape(
                lambda: jm.init_cache(pshape, batch, seq))
            want = jcache_specs(cshape, jmesh)
            host = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                cshape)
            got = cache_specs(lm_cache_from_jax(host, cfg, device="meta"),
                              mesh)
            _check_cache(arch, want, got, cfg)


def _check_cache(arch, want, got, cfg):
    from repro_torch.models.transformer import superblock_kinds
    for layer, entry in enumerate(got):
        if cfg.family == "encdec":
            jentry = want
        else:
            jentry = want[f"b{layer % len(superblock_kinds(cfg))}"]
        for k, spec in entry.items():
            jspec = tuple(jentry[k].spec)
            if spec is None:                          # an int idx
                assert jspec == (), (arch, k, jspec)
                continue
            jspec = jspec[1:] if jspec else ()        # drop R
            assert spec == jspec, (arch, layer, k, spec, jspec)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh(pod=2, data=4, model=2)
    assert placements(("model", "data"), mesh) == (
        Replicate(), Shard(1), Shard(0))
    assert placements(((("pod", "data")), None), mesh) == (
        Shard(0), Shard(0), Replicate())
    assert placements((None, ("data", "model")), _Mesh(data=2, model=2)) \
        == (Shard(1), Shard(1))
    assert placements((), mesh) == (Replicate(),) * 3
