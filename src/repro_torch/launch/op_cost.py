"""Per-card cost of one step, counted from a trace on fake tensors; port of
``repro.launch.hlo_cost``.

The JAX package walks the partitioned HLO of a compiled step. The port
has no compiled program: it runs the step itself, eagerly, on fake tensors
(``FakeTensorMode``: shapes, dtypes and strides, no storage) under a fake
process group of the production world size (``fake_mesh``), in which this
process is rank 0 and every collective returns a tensor of the right shape
without moving a byte. Everything is counted per card, for rank 0, the
fullest card (a dim split unevenly leaves its longest piece on rank 0).

Under a DTensor mesh a dispatch hook sees three kinds of op: (a) the ops
the model calls, on DTensors at global shapes; (b) the ops DTensor's
sharding propagation evaluates on fake tensors at global shapes to learn an
output's shape; (c) the ops on each rank's local shards that DTensor then
runs, collectives included. Only (c) is a card's work. The counter is a
dispatch mode that hands every DTensor op on to DTensor (as
``CommDebugMode`` does) and so sees (c); it ignores everything evaluated
inside ``ShardingPropagator._propagate_tensor_meta_non_cached`` (b). That
rule does not depend on propagation's cache: the local ops run on every
call, so a loop of identical layers counts once per layer.

  * FLOPs: ``torch.utils.flop_counter.flop_registry`` on each local op
    (matmuls, convolutions, attention), as ``FlopCounterMode`` counts.
  * HBM bytes: eager PyTorch runs one kernel per op, so each local compute
    op reads its tensor inputs and writes its outputs (hlo_cost's
    per-instruction rule). Views, metadata, allocations without a write
    and ``wait_tensor`` move nothing (hlo_cost's ``_SKIP_BYTES``). A
    ``_to_copy`` to a new dtype also counts into ``convert_bytes``.
  * Collectives: each ``_c10d_functional`` collective's result bytes, by
    JAX's kinds and with JAX's link weights (all-reduce 2x), and by the
    mesh axes its group spans (``coll_axes``), which the roofline turns
    into a link rate. A collective adds its result bytes to the HBM bytes
    too, as in hlo_cost.
  * All-to-all: DTensor's CPU mesh has no all-to-all and falls back to an
    all-gather and a chunk, where the card runs NCCL's all-to-all. The
    trace runs on a CPU mesh: a CUDA-typed mesh can be built over the fake
    group without a card, but a CPU build of PyTorch cannot run the
    all-to-all's fake kernel on fake CUDA tensors. So the counter maps the
    fallback back: ``shard_dim_alltoall`` on a CPU mesh counts one
    all-to-all of its result's bytes, and nothing that runs inside it. On
    a card's mesh the ``_dtensor.shard_dim_alltoall`` op counts so itself
    (held equal on four H100s: chip_smoke.py phase 12).
  * Peak memory: the high-water mark of the bytes of live storages on rank
    0, from the state handed to the step (params, moments, batch, cache)
    through the step. A storage is counted from the op that makes it to
    the moment it is freed (a weak reference's finalizer). A view's output
    is never counted: fake tensors' views can carry storages of their own
    (the fake dispatch cache rebuilds them), where on a card they share
    their base's. The steps update their state in place, as JAX's
    donation does.

``CollectiveCounter`` counts a real step's collectives by the same rules
(a ``CommDebugMode`` with bytes), so that a trace can be held to a run on
gloo or NCCL.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["Cost", "COLL_WEIGHT", "fake_mesh", "step_cost",
           "CollectiveCounter", "tensor_bytes"]

#: JAX's collective kinds and link weights (hlo_cost._COLL_WEIGHT): a ring
#: all-reduce moves its bytes twice (reduce-scatter + all-gather phases).
COLL_WEIGHT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

#: ``_c10d_functional`` op -> JAX's kind.
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_gather_into_tensor_out": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "all_reduce_coalesced_": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "reduce_scatter_tensor_out": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all"}

#: Ops that allocate without writing, or only read metadata.
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "lift_fresh_copy",
               "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
               "sym_storage_offset", "is_same_size", "is_pinned",
               "_has_compatible_shallow_copy_type", "set_", "resize_",
               "_unsafe_view", "_reshape_alias", "alias"}


def _zero_kinds():
    return {k: 0.0 for k in COLL_WEIGHT}


@dataclasses.dataclass
class Cost:
    """hlo_cost's ``Cost``, per card. ``coll_count`` counts collectives by
    kind; ``coll_axes`` holds the link-weighted bytes by the mesh axes
    the group spans ("model", "data", "pod+data", ...)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0            # link-weighted
    convert_bytes: float = 0.0         # dtype-convert traffic
    coll_raw: dict = dataclasses.field(default_factory=_zero_kinds)
    coll_count: dict = dataclasses.field(default_factory=_zero_kinds)
    coll_axes: dict = dataclasses.field(default_factory=dict)

    def __iadd__(self, o):
        self.flops += o.flops
        self.bytes += o.bytes
        self.coll_bytes += o.coll_bytes
        self.convert_bytes += o.convert_bytes
        for k in self.coll_raw:
            self.coll_raw[k] += o.coll_raw[k]
            self.coll_count[k] += o.coll_count[k]
        for k, v in o.coll_axes.items():
            self.coll_axes[k] = self.coll_axes.get(k, 0.0) + v
        return self

    def scaled(self, m: float) -> "Cost":
        return Cost(self.flops * m, self.bytes * m, self.coll_bytes * m,
                    self.convert_bytes * m,
                    {k: v * m for k, v in self.coll_raw.items()},
                    {k: v * m for k, v in self.coll_count.items()},
                    {k: v * m for k, v in self.coll_axes.items()})


def tensor_bytes(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor, or a nest of them)."""
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _tensors(x):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


@functools.lru_cache(maxsize=None)
def _group_arg(func) -> int:
    """Position of a collective's ``group_name`` argument (-1: none)."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == "group_name":
            return i
    return -1


def _group_axes(mesh, name: str) -> str:
    """The mesh axes a process group spans, joined by '+' in mesh order
    ('?' when the group is not one of ``mesh``'s)."""
    if mesh is None:
        return "?"
    import numpy as np
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.distributed_c10d import _resolve_process_group
    ranks = dist.get_process_group_ranks(_resolve_process_group(name))
    with unset_fake_temporarily():
        grid = np.asarray(mesh.mesh.tolist())
    coords = [np.argwhere(grid == r) for r in ranks]
    if any(len(c) != 1 for c in coords):
        return "?"
    coords = np.concatenate(coords)
    spans = [mesh.mesh_dim_names[d] for d in range(grid.ndim)
             if len(set(coords[:, d])) > 1]
    return "+".join(spans) if spans else "-"


class _Patches:
    """The two hooks the counters need inside DTensor, installed while a
    counter is active: a flag around sharding propagation's fake
    evaluations, and the CPU mesh's all-to-all fallback counted as the
    card's all-to-all."""
    active: list = []
    saved: list = []

    @classmethod
    def push(cls, counter):
        cls.active.append(counter)
        if len(cls.active) > 1:
            return
        from torch.distributed.tensor import _collective_utils as cu
        from torch.distributed.tensor import placement_types as pt
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        prop = ShardingPropagator._propagate_tensor_meta_non_cached

        @functools.wraps(prop)
        def propagating(self, *a, **k):
            for c in cls.active:
                c._propagating += 1
            try:
                return prop(self, *a, **k)
            finally:
                for c in cls.active:
                    c._propagating -= 1

        a2a = cu.shard_dim_alltoall

        @functools.wraps(a2a)
        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            if mesh.device_type != "cpu":
                return a2a(input, gather_dim, shard_dim, mesh, mesh_dim)
            for c in cls.active:
                c._suppress += 1
            try:
                out = a2a(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                for c in cls.active:
                    c._suppress -= 1
            for c in cls.active:
                c._collective("all-to-all", out,
                              mesh.mesh_dim_names[mesh_dim])
            return out

        cls.saved = [(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                      prop)]
        ShardingPropagator._propagate_tensor_meta_non_cached = propagating
        for mod in (cu, pt):
            if getattr(mod, "shard_dim_alltoall", None) is a2a:
                cls.saved.append((mod, "shard_dim_alltoall", a2a))
                mod.shard_dim_alltoall = alltoall

    @classmethod
    def pop(cls, counter):
        cls.active.remove(counter)
        if not cls.active:
            for owner, name, orig in cls.saved:
                setattr(owner, name, orig)
            cls.saved = []


class _Counter(TorchDispatchMode):
    """Counts the local ops of whatever runs under it (see the module
    docstring): ``cost``, and with ``track`` the live storage bytes
    (``live``) and their high-water mark (``peak``)."""

    def __init__(self, mesh=None, track: bool = True):
        super().__init__()
        self.mesh = mesh
        self.track = track
        self.cost = Cost()
        self.live = 0
        self.peak = 0
        self._storages = {}
        self._axes = {}
        self._propagating = 0
        self._suppress = 0

    def __enter__(self):
        _Patches.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _Patches.pop(self)

    # -- live storages ---------------------------------------------------
    def hold(self, x):
        """Count the storages of every tensor in ``x`` (a DTensor's local
        shard) as live from now until each is freed."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(x):
            if isinstance(t, DTensor):
                t = t._local_tensor
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            nb = st.nbytes()
            self._storages[key] = nb
            self.live += nb
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    # -- counting --------------------------------------------------------
    def _collective(self, kind: str, out, axes: str):
        b = tensor_bytes(out)
        c = self.cost
        c.coll_raw[kind] += b
        c.coll_count[kind] += 1
        c.coll_bytes += b * COLL_WEIGHT[kind]
        c.coll_axes[axes] = c.coll_axes.get(axes, 0.0) + b * COLL_WEIGHT[kind]
        c.bytes += b
        if self.track:
            self.hold(out)

    def _axes_of(self, func, args, kwargs) -> str:
        i = _group_arg(func)
        name = kwargs.get("group_name", args[i] if 0 <= i < len(args)
                          else None)
        if not isinstance(name, str):
            return "?"
        if name not in self._axes:
            self._axes[name] = _group_axes(self.mesh, name)
        return self._axes[name]

    def account(self, func, args, kwargs, out):
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns.startswith("_c10d_functional") or (
                ns == "_dtensor" and name == "shard_dim_alltoall"):
            if name in ("wait_tensor", "_wrap_tensor_autograd"):
                return
            if name not in _KIND:
                raise NotImplementedError(f"uncounted collective {func}")
            self._collective(_KIND[name], out,
                             self._axes_of(func, args, kwargs))
            return
        if ns in ("c10d", "c10d_functional"):
            raise NotImplementedError(f"uncounted collective {func}")
        if self.track and not func.is_view:   # a view allocates nothing
            self.hold(out)
        pk = func._overloadpacket
        if pk in flop_registry:
            self.cost.flops += flop_registry[pk](*args, **kwargs,
                                                 out_val=out)
        if func.is_view or name in _NO_TRAFFIC or ns == "prim":
            return
        nin = tensor_bytes((args, kwargs))
        nout = tensor_bytes(out)
        self.cost.bytes += nin + nout
        if name == "_to_copy" and isinstance(out, torch.Tensor) and (
                out.dtype != args[0].dtype):
            self.cost.convert_bytes += nin + nout

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # (a): let DTensor run its local ops
        out = func(*args, **kwargs)
        if not (self._propagating or self._suppress):
            self.account(func, args, kwargs, out)
        return out


class CollectiveCounter(_Counter):
    """``CommDebugMode`` for a real step, with bytes: counts of each
    collective the step runs and their result bytes, by JAX's kinds
    (``counts``, ``raw``), under the trace's rules (the CPU mesh's
    all-to-all fallback counts as one all-to-all). Use it as a context
    manager around the step."""

    def __init__(self, mesh=None):
        super().__init__(mesh, track=False)

    @property
    def counts(self) -> dict:
        return dict(self.cost.coll_count)

    @property
    def raw(self) -> dict:
        return dict(self.cost.coll_raw)


@contextlib.contextmanager
def fake_mesh(axes: dict):
    """A fake process group of ``prod(axes)`` ranks in which this process
    is rank 0, a CPU ``DeviceMesh`` over it with ``axes``' names and
    sizes ({name: size}, outermost first), and fake tensors: every tensor
    made inside is a ``FakeTensor``. Yields the mesh; destroys the group
    after. Raises if a process group already exists."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    # importing fake_pg registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_mesh needs a process without a process "
                           "group")
    world = math.prod(axes.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", tuple(axes.values()),
                                mesh_dim_names=tuple(axes))
        with FakeTensorMode(allow_non_fake_inputs=True):
            yield mesh
    finally:
        dist.destroy_process_group()


def step_cost(fn, *args, mesh=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and count what rank 0 executes:
    ``(Cost, peak live bytes, fn's result)``. The peak starts from the
    storages of ``args`` (the state handed to the step) and follows every
    storage the step makes until it is freed. Run it inside
    ``fake_mesh`` for a sharded step, or on plain tensors (fake or real)
    for one device."""
    counter = _Counter(mesh)
    counter.hold((args, kwargs, _module_tensors(args)))
    with counter:
        out = fn(*args, **kwargs)
    return counter.cost, counter.peak, out


def _module_tensors(args) -> list:
    """The parameters of every ``nn.Module`` among ``args``."""
    return [list(a.parameters()) for a in args
            if isinstance(a, torch.nn.Module)]
