"""Activation-sharding context; port of ``repro.distributed.ctx``.

Model code is mesh-agnostic; the launch layer declares which mesh axes carry
the batch dim (('pod','data') / ('data',)) and model code pins activations
to it at layer boundaries via ``constrain_batch``. Without this, sharding
propagation carries the FSDP param sharding INTO activations (the embedding
lookup of a table sharded over ('model', 'data') comes out sharded over its
d_model dim), which costs memory and collectives. No-op when no axes are set
(tests, single-device runs) and on plain tensors.

One port-only detail: JAX reads the mesh from the ambient ``with mesh:``;
here the context also holds the ``DeviceMesh`` (``set_mesh``; the train
step sets it with the batch axes). Activations that are DTensors carry
their own mesh, and ``constrain_batch`` redistributes on it. Where GSPMD
partitions any op and pads uneven shards, DTensor needs help, which the
rest of this module gives the model code: ``unflatten``/``flatten`` for
head splits that do not divide the mesh, and ``local`` for ops that run
on each rank's shards under a stated layout.
"""
from __future__ import annotations

import contextlib

import torch

_BATCH_AXES = None
_SEQ_AXES = None
_DATA_SIZE = None    # product of the data-like axis sizes (divisibility)
_MESH = None


def set_batch_axes(axes):
    """axes: None | str | tuple — mesh axes of the global batch dim."""
    global _BATCH_AXES
    _BATCH_AXES = axes


def set_seq_axes(axes):
    """Sequence-parallel residual stream: mesh axes of dim 1 (seq) of
    (B, S, d) activations. Used when the batch is too small to cover the
    data-like axes (e.g. prefill_32k at batch 32 on 256 chips)."""
    global _SEQ_AXES
    _SEQ_AXES = axes


def set_data_size(n):
    global _DATA_SIZE
    _DATA_SIZE = n


def set_mesh(mesh):
    """The ``DeviceMesh`` that the sharded step runs on (None: none)."""
    global _MESH
    _MESH = mesh


def get_data_size():
    return _DATA_SIZE


def get_batch_axes():
    return _BATCH_AXES


def get_seq_axes():
    return _SEQ_AXES


def get_mesh():
    return _MESH


@contextlib.contextmanager
def batch_axes(axes):
    prev = _BATCH_AXES
    set_batch_axes(axes)
    try:
        yield
    finally:
        set_batch_axes(prev)


def _axes(axes) -> tuple:
    return () if axes is None else (axes if isinstance(axes, tuple)
                                    else (axes,))


class _Pin(torch.autograd.Function):
    """``x`` laid out as ``want``, and its gradient as ``grad_want``: the
    backward lays the gradient out as stated instead of handing it back
    in whatever layout it arrives (a partial sum over 'model' from the
    vocabulary-sharded logits would otherwise flow down the residual
    stream, and every 'model' rank would compute each backward product
    whole on its partial gradient)."""

    @staticmethod
    def forward(ctx, x, want, grad_want):
        ctx.grad_want = grad_want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.grad_want:
            g = g.redistribute(g.device_mesh, ctx.grad_want)
        return g, None, None


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 of ``x`` (and of its gradient) to the batch axes (+ dim 1
    to the seq axes when sequence parallelism is on), rest replicated:
    a DTensor on a mesh whose batch is not split is pinned whole."""
    from torch.distributed.tensor import DTensor
    if x.ndim == 0 or not isinstance(x, DTensor):
        return x
    dims = {0: _BATCH_AXES}
    if _SEQ_AXES is not None and x.ndim >= 3:
        dims[1] = _SEQ_AXES
    want = _layout(x.device_mesh, dims)
    if not x.requires_grad:
        return x if tuple(x.placements) == want else x.redistribute(
            x.device_mesh, want)
    return _Pin.apply(x, want, want)


def weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w`` for the product ``x @ w``: gathered over the data-like mesh
    axes first, as GSPMD gathers an FSDP weight, where the activations'
    batch does not cover exactly those axes and the product has many
    rows. There, left to DTensor, the product with a weight sharded over
    the data axes on its contraction dim comes out as a partial sum over
    them, every rank computing products of rows that are not its own:
    under ``strategy="fsdp"`` (the batch over ('data', 'model'), or the
    sequence over 'model') 1.7x the per-card FLOPs of JAX's step, and for
    a batch left whole (a prefill of fewer rows than data ranks) every
    product's output all-reduced over them. Every 'pod' and 'data' shard
    is made whole, and a 'model' shard too where it splits the same dim
    as one of them (fsdp's ('data', 'model') dim); a 'model' shard of a
    dim of its own (TP, EP) is kept. The gradient comes back through the
    gather's backward, reduce-scattered onto the weight's shards.

    ``w`` passes as it is where DTensor's choice costs less: a batch
    split over exactly the data axes (tp), where DTensor gathers the
    weight or moves the activations, whichever moves fewer bytes; and a
    whole batch of fewer rows than the contraction dim (a decode step of
    a batch left whole), whose partial sums move fewer bytes than the
    weight would. Plain tensors pass too."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    batch = set(_axes(_BATCH_AXES))
    if _SEQ_AXES is None and batch == {a for a in names if a != "model"}:
        return w
    if not batch and x.numel() // x.shape[-1] < w.shape[0]:
        return w
    pls = list(w.placements)
    data_dims = {p.dim for a, p in zip(names, pls)
                 if isinstance(p, Shard) and a != "model"}
    out = [Replicate() if isinstance(p, Shard) and (
        a != "model" or p.dim in data_dims) else p
        for a, p in zip(names, pls)]
    if out == pls:
        return w
    return w.redistribute(w.device_mesh, tuple(out))


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, with its gradient laid out as ``x`` is (replicated
    where ``x`` is a partial sum). Where the consumers of a sharded
    product take it whole (a split across the sharded dim), its gradient
    comes back whole, and DTensor, which weighs only communication, may
    then compute the product's weight gradient whole on every rank;
    pinned, it slices the gradient (no communication) and computes its
    own shard."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    pls = tuple(x.placements)
    return _Pin.apply(x, pls, tuple(Replicate() if p.is_partial() else p
                                    for p in pls))


def unflatten(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``. When ``dim`` of a DTensor is sharded
    over more pieces than ``sizes[0]`` divides into (2 kv heads on a 4-way
    'model' axis), those mesh dims are replicated first: DTensor cannot
    split an uneven shard, where GSPMD pads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(x, DTensor):
        dim %= x.ndim
        pl = list(x.placements)
        on = [i for i, p in enumerate(pl)
              if isinstance(p, Shard) and p.dim % x.ndim == dim]
        n = 1
        for i in on:
            n *= x.device_mesh.size(i)
        if sizes[0] % n:
            for i in on:
                pl[i] = Replicate()
            x = x.redistribute(x.device_mesh, tuple(pl))
    return x.unflatten(dim, sizes)


class _WholeGrad(torch.autograd.Function):
    """Identity whose backward makes ``dim`` of the gradient whole."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate, Shard
        pl = tuple(Replicate() if isinstance(p, Shard)
                   and p.dim % g.ndim == ctx.dim % g.ndim else p
                   for p in g.placements)
        if pl != tuple(g.placements):
            g = g.redistribute(g.device_mesh, pl)
        return g, None


def flatten(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.flatten(dim)``: dims ``dim``.. merged (heads x head_dim). The
    backward of the merge splits the merged dim again, which DTensor
    cannot do for a gradient sharded over more pieces than ``x.shape[dim]``
    divides into (6 heads on a 4-way 'model' axis); there the gradient is
    made whole on that dim first."""
    from torch.distributed.tensor import DTensor
    y = x.flatten(dim)
    if (isinstance(x, DTensor) and y.requires_grad
            and x.shape[dim] % x.device_mesh.size()):
        y = _WholeGrad.apply(y, dim)
    return y


def _layout(mesh, dims: dict, partial=None) -> tuple:
    """Placements on ``mesh``: tensor dim ``d`` sharded over the axes
    ``dims[d]``, a partial sum over the axes ``partial``, the rest
    replicated. Axes the mesh lacks are dropped."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    for d, axes in dims.items():
        for a in _axes(axes):
            if a in names:
                out[names.index(a)] = Shard(d)
    for a in _axes(partial):
        if a in names:
            out[names.index(a)] = Partial()
    return tuple(out)


def local(fn, ins, outs):
    """``fn`` over local shards, for an op that is local under the given
    layouts: attention and the SSD scan over batch- and head-sharded
    tensors, a depthwise convolution over batch- and channel-sharded
    activations, an embedding lookup of batch-sharded ids in a whole
    table, MoE routing of each rank's groups and experts sharded over
    'model' applied to their own tokens. Also where DTensor has no rule
    for an op inside ``fn``, or splits a dim unevenly.

    ``ins``: (tensor, {dim: axes}, sum_axes) each: the tensor is laid out
    as ``{dim: axes}`` says (every other mesh dim replicated), and its
    gradient comes back as a partial sum over ``sum_axes`` (the axes that
    shard the rows a weight is applied to). ``outs``: ({dim: axes},
    partial_axes) for each output of ``fn`` (a tensor or a tuple), which
    is rewrapped so. Shards must be even. Without DTensors ``fn`` runs on
    the tensors as they are."""
    from torch.distributed.tensor import DTensor
    first = next((t for t, _, _ in ins if isinstance(t, DTensor)), None)
    if first is None:
        return fn(*[t for t, _, _ in ins])
    mesh = first.device_mesh
    args = []
    for t, dims, sums in ins:
        if not isinstance(t, DTensor):     # whole on every rank
            args.append(t)
            continue
        pl = _layout(mesh, dims)
        if tuple(t.placements) != pl:
            t = t.redistribute(mesh, pl)
        args.append(t.to_local(grad_placements=_layout(mesh, dims, sums)))
    res = fn(*args)
    one = not isinstance(res, tuple)
    wrapped = tuple(DTensor.from_local(r, mesh, _layout(mesh, dims, part),
                                       run_check=False)
                    for r, (dims, part) in zip((res,) if one else res, outs))
    return wrapped[0] if one else wrapped


def shards(axes) -> int:
    """How many pieces ``axes`` split a dim into on the current mesh (1
    off a mesh)."""
    from .sharding import axis_size
    return 1 if _MESH is None else axis_size(_MESH, axes)


def even_axes(axes, n: int):
    """``axes`` when they split a dim of ``n`` evenly on the current mesh,
    else None."""
    return axes if axes is not None and n % shards(axes) == 0 else None


def model_axes(n: int):
    """'model' for a dim of ``n`` (heads, channels, experts) when it
    divides evenly on the current mesh and the batch is not on it, else
    None."""
    if "model" in _axes(_BATCH_AXES):
        return None
    return even_axes("model", n)
