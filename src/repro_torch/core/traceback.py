"""Traceback strategies (paper §IV-D); port of ``repro.core.traceback``.

* ``serial_traceback``   — one cursor chases the whole frame.
* ``parallel_traceback`` — the kept region is split into ``nsub`` subframes
  of ``f0`` stages, each traced back concurrently with a right-overlap of
  ``v2s`` convergence stages (paper Fig. 5), starting from the per-stage
  argmax state (``start='boundary'``) or from state 0 (``'fixed'``).

Both take optional leading batch dimensions: ``sel (..., L, S)`` (or
packed ``(..., L, W)`` int32 words), one cursor set per batch entry. The
``*_frames`` variants over the split kernel's survivor streams come with
that kernel, in the next slice of the port.
"""
from __future__ import annotations

import torch

from .trellis import Trellis

__all__ = ["serial_traceback", "parallel_traceback"]


def _sel_bit(sel_t: torch.Tensor, states: torch.Tensor,
             packed: bool) -> torch.Tensor:
    """Selector bit of ``states`` (..., C) from rows ``sel_t`` (..., C, S|W)."""
    if packed:
        word = torch.gather(sel_t.to(torch.int32), -1,
                            (states >> 5)[..., None])[..., 0]
        return (word >> (states & 31).to(torch.int32)).to(torch.long) & 1
    return torch.gather(sel_t.to(torch.long), -1, states[..., None])[..., 0]


def serial_traceback(sel: torch.Tensor, trellis: Trellis,
                     start_state: torch.Tensor, v1: int, f: int,
                     packed: bool = False) -> torch.Tensor:
    """Chase from the last stage; return the f kept bits [v1, v1+f).

    ``packed=True`` reads sel as (..., L, ceil(S/32)) int32 words."""
    prev_state = torch.as_tensor(trellis.prev_state, dtype=torch.long,
                                 device=sel.device)
    kshift = trellis.k - 2
    j = torch.as_tensor(start_state, device=sel.device).to(torch.long)
    L = sel.shape[-2]
    bits = [None] * L
    for t in range(L - 1, -1, -1):
        bits[t] = j >> kshift
        p = _sel_bit(sel[..., t, None, :], j[..., None], packed)[..., 0]
        j = prev_state[j, p]
    return torch.stack(bits[v1:v1 + f], -1).to(torch.int32)


def parallel_traceback(sel: torch.Tensor, amax: torch.Tensor,
                       trellis: Trellis, v1: int, f: int, f0: int, v2s: int,
                       start: str = "boundary",
                       packed: bool = False) -> torch.Tensor:
    """Parallel traceback over ``nsub = f // f0`` subframes.

    sel: (..., L, S) selectors, or (..., L, W) packed words; amax (..., L).
    Returns (..., f) int32 decoded bits."""
    if f % f0 != 0:
        raise ValueError("f must be a multiple of f0 (paper §IV-E alignment)")
    nsub = f // f0
    L = sel.shape[-2]
    if v1 + f + v2s > L:
        raise ValueError("need v2 >= v2s")
    dev = sel.device
    prev_state = torch.as_tensor(trellis.prev_state, dtype=torch.long,
                                 device=dev)
    kshift = trellis.k - 2
    batch = sel.shape[:-2]

    q = torch.arange(nsub, device=dev)
    e = v1 + (q + 1) * f0 - 1 + v2s                   # chase start stages
    if start == "boundary":
        states = amax.to(torch.long)[..., e]          # (..., nsub)
    elif start == "fixed":
        states = torch.zeros((*batch, nsub), dtype=torch.long, device=dev)
    else:
        raise ValueError(start)

    bits = []
    for r in range(f0 + v2s):
        bits.append(states >> kshift)                 # bits at stages e - r
        rows = sel[..., e - r, :]                     # (..., nsub, S|W)
        states = prev_state[states, _sel_bit(rows, states, packed)]
    # the first v2s emitted bits are the convergence overlap; the rest,
    # reversed, are each subframe's stages in ascending order
    kept = torch.stack(bits[v2s:][::-1], -1)          # (..., nsub, f0)
    return kept.reshape(*batch, f).to(torch.int32)
