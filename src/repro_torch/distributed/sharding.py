"""Logical-axis sharding rules -> DTensor placements; port of
``repro.distributed.sharding``.

TP over 'model' (heads / d_ff / experts / vocab), FSDP-style weight
sharding over 'data', batch over ('pod', 'data'). Rules are
right-aligned to the trailing dims. The JAX package stacks a layer list
along a leading repeat axis that its rules leave unsharded; the port
keeps each layer in an ``nn.ModuleList`` entry (``layers.3.mixer.wq``
where JAX has ``blocks.b0.mixer.wq``), so a layer leaf's spec here is
JAX's without its leading ``None``.

A spec is a tuple with one entry per tensor dim: ``None``, a mesh axis
name, or a tuple of axis names (the dim split over several axes, the
first outermost). ``placements(spec, mesh)`` turns it into one DTensor
placement per mesh dim. A dim that does not divide its axes is still
sharded: DTensor splits it as ``torch.chunk`` does (the last shards are
shorter or empty) where GSPMD pads.
"""
from __future__ import annotations

import re
from typing import NamedTuple

import torch
from torch import nn

__all__ = ["param_specs", "param_shardings", "batch_specs", "cache_specs",
           "moment_specs", "placements", "place", "distribute", "axis_size",
           "Sharding", "state_shardings", "place_state"]

# (regex on the leaf's dotted path, spec for the TRAILING dims)
_RULES = [
    (r"\btok$",                       ("model", "data")),
    (r"\bhead$",                      ("data", "model")),
    (r"\b(wq|wk|wv|wqkv|wg|wu|in_proj)$",  ("data", "model")),
    (r"\b(wo|wd|out_proj)$",          ("model", "data")),
    (r"\brouter$",                    ("data", None)),
    (r"\b(ewg|ewu)$",                 ("model", "data", None)),
    (r"\bewd$",                       ("model", None, "data")),
    (r"\b(bq|bk|bv|bqkv|conv_b|A_log|dt_bias)$", ("model",)),
    (r"\bD$",                         ("model",)),
    (r"\bconv_w$",                    (None, "model")),
]


def _spec_for(path: str, ndim: int, data_axes) -> tuple:
    for pat, trailing in _RULES:
        if re.search(pat, path):
            if len(trailing) > ndim:       # scalar-ish leaf, replicate
                return ()
            return tuple([None] * (ndim - len(trailing)) + [
                (data_axes if a == "data" else a) for a in trailing])
    return ()                              # norms / scalars: replicated


def _named(params):
    """(name, tensor-like) pairs: a module's parameters or a dict's
    items (moments, shape stand-ins)."""
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    return list(params.items())


def param_specs(params, shard_data: bool = True, data_axes="data",
                strategy: str = "tp") -> dict:
    """{name: spec} for every parameter of ``params`` (a ``Params``
    module, or a dict of tensors keyed by parameter name).

    strategy:
      'tp'   — TP over 'model' (heads/ffn/experts/vocab) + FSDP over 'data'
               (the baseline).
      'fsdp' — pure FSDP/ZeRO-3: weight matrices sharded over
               ('data','model') on their (previously-)data dim, no TP
               contraction all-reduces. Expert dims (ewg/ewu/ewd) keep EP
               over 'model'. Batch then shards over BOTH axes.
    shard_data=False turns off the FSDP dimension (pure-TP params), used by
    small-model tests and the compressed-DP path.
    """
    fsdp_axes = (tuple(data_axes) if isinstance(data_axes, tuple)
                 else (data_axes,)) + ("model",)

    def one(name, leaf):
        spec = _spec_for(name, len(leaf.shape), data_axes)
        if strategy == "fsdp" and not re.search(r"\b(ewg|ewu|ewd)$", name):
            spec = tuple(fsdp_axes if a == data_axes or a == "data"
                         else (None if a == "model" else a) for a in spec)
        if not shard_data:
            spec = tuple(None if a in ("data", data_axes) else a
                         for a in spec)
        return spec
    return {n: one(n, p) for n, p in _named(params)}


def moment_specs(params, zero_pod: bool = False) -> dict:
    """Optimizer-moment specs: same as params, optionally sharding the
    'data'-sharded dim over ('pod','data') (ZeRO over pods)."""
    return param_specs(params,
                       data_axes=("pod", "data") if zero_pod else "data")


def axis_size(mesh, axes) -> int:
    """The number of shards of ``axes`` (a name, a tuple, or None)."""
    if axes is None:
        return 1
    names = mesh.mesh_dim_names
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh.size(names.index(a)) if a in names else 1
    return n


def placements(spec: tuple, mesh) -> tuple:
    """A spec -> one DTensor placement per mesh dim: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere. Axes
    the mesh lacks are dropped (a one-pod mesh has no 'pod'). Where one
    dim names several axes, DTensor shards it over them in mesh-dim order,
    which is the order JAX lays them out in when that order is the mesh's
    (('pod', 'data'), ('data', 'model'))."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, pls: tuple):
    """A full tensor that every rank holds alike -> a DTensor with
    placements ``pls``: each rank keeps its own piece, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.detach(), mesh, pls, src_data_rank=None)


def place(t: torch.Tensor, mesh, spec: tuple):
    """Distribute a full tensor (the same on every rank) over ``mesh``
    by ``spec``."""
    return distribute(t, mesh, placements(spec, mesh))


def _set_param(root: nn.Module, name: str, value: torch.Tensor):
    owner, _, leaf = name.rpartition(".")
    mod = root.get_submodule(owner) if owner else root
    mod.register_parameter(leaf, nn.Parameter(value, requires_grad=True))


def param_shardings(mesh, params, **kw):
    """Place a ``Params`` tree on ``mesh`` in place: every parameter
    becomes an ``nn.Parameter`` holding a DTensor laid out by
    ``param_specs(params, **kw)``. Returns ``params``."""
    specs = param_specs(params, **kw)
    for name, p in list(params.named_parameters()):
        _set_param(params, name, place(p, mesh, specs[name]))
    return params


class Sharding(NamedTuple):
    """A mesh and a spec: where one leaf of a state goes (JAX's
    ``NamedSharding``)."""
    mesh: object
    spec: tuple


def state_shardings(mesh, state: dict, **kw) -> dict:
    """{checkpoint key: Sharding} for a training state ``{"params":
    Params, "opt": {"m": {...}, "v": {...}, "step": scalar}}``: params and
    moments by ``param_specs(params, **kw)``; the step counter stays a
    plain tensor, as AdamW keeps it (None). The keys are
    ``train.checkpoint``'s (``params/layers.0.ln1``,
    ``opt/m/layers.0.ln1``, ``opt/step``)."""
    specs = param_specs(state["params"], **kw)
    out = {f"params/{n}": Sharding(mesh, s) for n, s in specs.items()}
    for mom in ("m", "v"):
        out.update({f"opt/{mom}/{n}": Sharding(mesh, specs[n])
                    for n in state["opt"][mom]})
    out["opt/step"] = None
    return out


def _full(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t.detach()


def place_state(state: dict, shardings: dict) -> dict:
    """Place a training state by ``shardings`` ({checkpoint key:
    Sharding, or None for a leaf that stays a plain tensor), in place
    (params re-registered, the optimizer's dicts rebuilt), one leaf at a
    time. A plain leaf is taken as whole and the
    same on every rank (no communication); a DTensor leaf, on any mesh, is
    made whole first with ``full_tensor``, a collective that every rank of
    its mesh joins. Returns the state."""
    def one(t, sh):
        return _full(t) if sh is None else place(_full(t), sh.mesh, sh.spec)

    params = state["params"]
    for name, p in list(params.named_parameters()):
        _set_param(params, name, one(p, shardings[f"params/{name}"]))
    opt = {}
    for k, v in state["opt"].items():
        opt[k] = ({n: one(t, shardings[f"opt/{k}/{n}"])
                   for n, t in v.items()} if isinstance(v, dict)
                  else one(v, shardings[f"opt/{k}"]))
    return {"params": params, "opt": opt}


def _data_axes(mesh, strategy: str):
    names = ("pod", "data", "model") if strategy == "fsdp" else ("pod", "data")
    axes = tuple(a for a in names if a in mesh.mesh_dim_names)
    return (axes if len(axes) > 1 else (axes[0] if axes else None)), \
        axis_size(mesh, axes)


def batch_specs(batch: dict, mesh, strategy: str = "tp") -> dict:
    """{name: spec} for a batch dict: dim 0 over all data-like mesh axes
    present (replicated when the global batch doesn't divide them, e.g.
    long_500k's batch of 1). In 'fsdp' strategy the 'model' axis is
    data-like too. Leaves are anything with a ``shape``."""
    ax, dsize = _data_axes(mesh, strategy)

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0 or shape[0] % dsize:
            return ()
        return (ax,) + (None,) * (len(shape) - 1)
    return {k: one(v) for k, v in batch.items()}


def cache_specs(cache, mesh):
    """Decode-state specs, in the structure of the port's cache (a list
    of per-layer dicts, or any nesting of dicts and lists).

    KV caches (B, S, KV, hd): batch over data axes (when divisible);
    KV heads over 'model' when divisible, else the SEQUENCE dim over
    'model' (sequence-parallel cache — the long_500k path for archs whose
    kv count doesn't divide the model axis).
    SSM states (B, H, N, P): heads over 'model'. Conv states (B, K, C):
    channels over 'model'. Ints (an attention cache's ``idx``) get None.
    """
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    ax = axes if len(axes) > 1 else (axes[0] if axes else None)
    msize = axis_size(mesh, "model")
    dsize = axis_size(mesh, axes)

    def one(name, leaf):
        if not hasattr(leaf, "shape"):
            return None
        shape = tuple(leaf.shape)
        if len(shape) == 0 or "idx" in name:
            return ()
        spec = [None] * len(shape)
        if shape[0] % dsize == 0:
            spec[0] = ax
        if name in ("k", "v", "xk", "xv") and len(shape) == 4:
            if shape[2] % msize == 0:
                spec[2] = "model"          # kv heads
            elif shape[1] % msize == 0:
                spec[1] = "model"          # sequence-parallel cache
        elif name == "ssm" and len(shape) == 4:       # (B,H,N,P)
            if shape[1] % msize == 0:
                spec[1] = "model"
        elif name == "conv" and len(shape) == 3:      # (B,K,C)
            if shape[2] % msize == 0:
                spec[2] = "model"
        return tuple(spec)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return one(name, node)
    return walk(cache)
