"""Restart-safe training loop with straggler watchdog and failure
recovery; port of ``repro.train.loop``.

  (a) per-step exception recovery: restore from the last complete
      checkpoint and continue (the synthetic pipeline is a pure function of
      the step index, so the data stream replays exactly);
  (b) an EMA watchdog flags steps slower than ``straggler_factor`` x EMA and
      invokes ``on_straggler`` (counted and logged: the policy hook);
  (c) atomic checkpoints every ``ckpt_every`` steps + resume-from-latest.

A step's time runs from before the step to the host's read of its
metrics (``float()``, which waits for the device), so it is the step's
device time and not only its dispatch. The step updates the state in
place; a restore loads the checkpoint into it, also when its tensors are
DTensors on a mesh (each rank loads its own shards; the checkpoint is
mesh-agnostic, ``checkpoint.py``).

Elasticity: ``elastic_rescale`` re-places a state on a different mesh,
leaf by leaf through whole tensors; the caller builds the step for the
new mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..distributed.sharding import place_state
from . import checkpoint as ckpt

__all__ = ["LoopConfig", "train_loop", "StepStats", "elastic_rescale"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    ema_decay: float = 0.9
    max_restores: int = 3


@dataclasses.dataclass
class StepStats:
    steps_run: int = 0
    restores: int = 0
    stragglers: int = 0
    last_loss: float = float("nan")


def train_loop(step_fn: Callable, state: dict, data_iter, lc: LoopConfig,
               fail_injector: Optional[Callable[[int], None]] = None,
               on_straggler: Optional[Callable[[int, float], None]] = None,
               log_every: int = 10) -> StepStats:
    """state = {'params':..., 'opt':...}; step_fn(params, opt, batch) ->
    (params, opt, metrics). Returns aggregate stats (used by tests)."""
    stats = StepStats()
    start = 0
    latest = ckpt.latest_step(lc.ckpt_dir)
    if latest is not None:
        state = ckpt.restore(lc.ckpt_dir, latest, state)
        start = latest + 1
    data_iter.step = start

    ema = None
    step = start
    while step < lc.total_steps:
        batch = next(data_iter)
        t0 = time.perf_counter()
        try:
            if fail_injector is not None:
                fail_injector(step)
            params, opt, metrics = step_fn(state["params"], state["opt"],
                                           batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            state = {"params": params, "opt": opt}
        except Exception:  # noqa: BLE001 — node failure simulation
            stats.restores += 1
            if stats.restores > lc.max_restores:
                raise
            latest = ckpt.latest_step(lc.ckpt_dir)
            if latest is not None:
                state = ckpt.restore(lc.ckpt_dir, latest, state)
                step = latest + 1
            else:
                step = 0
            data_iter.step = step
            continue
        dt = time.perf_counter() - t0
        if ema is not None and dt > lc.straggler_factor * ema:
            stats.stragglers += 1
            if on_straggler is not None:
                on_straggler(step, dt / ema)
        ema = dt if ema is None else lc.ema_decay * ema + (1 - lc.ema_decay) * dt
        stats.last_loss = metrics["loss"]
        stats.steps_run += 1
        if (step + 1) % lc.ckpt_every == 0 or step + 1 == lc.total_steps:
            ckpt.save(lc.ckpt_dir, step, state, keep=lc.keep)
        step += 1
    return stats


def elastic_rescale(state: dict, new_mesh, sharding_fn):
    """Re-place a training state onto a different mesh, in place.

    ``sharding_fn(mesh, state) -> {checkpoint key: Sharding}`` (e.g.
    ``distributed.sharding.state_shardings``). Every rank of the state's
    current mesh calls this: making a leaf whole is a collective. A rank
    outside ``new_mesh`` gets None back and takes no further part.
    """
    state = place_state(state, sharding_fn(new_mesh, state))
    return state if new_mesh.get_coordinate() is not None else None
