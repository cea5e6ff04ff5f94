"""Atomic checkpointing; port of ``repro.train.checkpoint``.

Layout: <dir>/step_<N>/arrays.npz + manifest.json. Writes go to a tmp dir
that is os.replace()'d into place, so a crash mid-save can never corrupt
the latest checkpoint. Arrays are stored as host numpy keyed by their
path in the state: a dict by its keys, a module by its ``state_dict``
names (``params/layers.0.ln1``, ``opt/m/layers.0.ln1``, ``opt/step``);
bf16 is widened to f32 in the npz. ``restore`` loads into the tensors of
the ``state_like`` it is given, in place and on their devices and dtypes
(as ``load_state_dict`` does). Async saves copy to the host on the
caller's thread and write on a daemon thread.

Under a mesh (``torch.distributed`` initialized, DTensor leaves) every
rank calls ``save``: each DTensor is made whole with ``full_tensor``, a
collective, so the file holds the same whole arrays as a single-device
checkpoint; rank 0 writes, and every rank waits at a barrier. The files
are therefore mesh-agnostic: ``restore`` loads a DTensor leaf by copying
its own piece of the whole array into its local shard, and with
``shardings`` ({key: ``Sharding``}) it places the loaded state on
another mesh (``distributed.sharding.place_state``) — the elastic
restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from ..distributed.sharding import distribute, place_state

__all__ = ["save", "restore", "latest_step", "Checkpointer"]

_SEP = "/"
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _join(prefix: str, key) -> str:
    return f"{prefix}{_SEP}{key}" if prefix else str(key)


def _items(tree):
    """A node's children, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return tree.state_dict(keep_vars=True).items()
    if isinstance(tree, dict):
        return tree.items()
    return None


def _dist() -> bool:
    return dist.is_available() and dist.is_initialized()


def _host(leaf) -> np.ndarray:
    """A copy on the host: the training step mutates its state in place.
    A DTensor is made whole first (a collective)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.is_floating_point() and t.dtype not in _NUMPY_FLOATS:
        t = t.float()                  # bf16 etc.: widen for npz
    return t.to("cpu", copy=True).numpy()


def _flatten(tree, prefix: str = "") -> dict:
    items = _items(tree)
    if items is None:
        return {prefix: _host(tree)}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, _join(prefix, k)))
    return flat


def _restore_into(tree, flat: dict, prefix: str = ""):
    items = _items(tree)
    if items is not None:
        out = {k: _restore_into(v, flat, _join(prefix, k))
               for k, v in items}
        return tree if isinstance(tree, nn.Module) else out
    arr = flat[prefix]
    if isinstance(tree, torch.Tensor):
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"{prefix}: checkpoint shape {arr.shape} != "
                             f"{tuple(tree.shape)}")
        with torch.no_grad():
            if isinstance(tree, DTensor):          # this rank's piece
                piece = distribute(torch.from_numpy(arr), tree.device_mesh,
                                   tree.placements)
                tree.to_local().copy_(piece.to_local())
            else:
                tree.copy_(torch.from_numpy(arr))
        return tree
    return arr.astype(tree.dtype) if hasattr(tree, "dtype") else arr


def _write(ckpt_dir: str, step: int, flat: dict, meta: Optional[dict],
           keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "complete": True, **(meta or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, state: Any, meta: Optional[dict] = None,
         keep: int = 3) -> str:
    """Every rank calls this under a mesh; rank 0 writes."""
    flat = _flatten(state)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not _dist() or dist.get_rank() == 0:
        final = _write(ckpt_dir, step, flat, meta, keep)
    if _dist():
        dist.barrier()
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(_all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _all_steps(ckpt_dir: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            man = os.path.join(ckpt_dir, name, "manifest.json")
            try:
                with open(man) as f:
                    if json.load(f).get("complete"):
                        out.append(int(name[5:]))
            except (OSError, ValueError):
                continue                        # torn checkpoint: ignored
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, state_like: Any,
            shardings: Any = None) -> Any:
    """Load a checkpoint into ``state_like`` (same structure): its tensors
    are overwritten in place, on their devices and in their dtypes (a
    DTensor's local shard by its placements); the state is returned.
    With ``shardings`` ({key: Sharding}, any mesh) ``state_like`` holds
    whole tensors and the loaded state is then placed by them."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    state = _restore_into(state_like, flat)
    if shardings is not None:
        state = place_state(state, shardings)
    return state


class Checkpointer:
    """Async wrapper: save() returns immediately; wait() joins the writer."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir, self.keep = ckpt_dir, keep
        self._thread: Optional[threading.Thread] = None

    def save_async(self, step: int, state: Any, meta: Optional[dict] = None):
        """Every rank calls this under a mesh: the gather to the host runs
        now, on every rank; rank 0 then writes on its thread."""
        flat = _flatten(state)         # host copy before the step mutates
        self.wait()
        if _dist() and dist.get_rank() != 0:
            return
        self._thread = threading.Thread(
            target=_write, args=(self.dir, step, flat, meta, self.keep),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
