"""Traceback strategies (paper §IV-D); port of ``repro.core.traceback``.

* ``serial_traceback``   — one cursor chases the whole frame.
* ``parallel_traceback`` — the kept region is split into ``nsub`` subframes
  of ``f0`` stages, each traced back concurrently with a right-overlap of
  ``v2s`` convergence stages (paper Fig. 5), starting from the per-stage
  argmax state (``start='boundary'``) or from state 0 (``'fixed'``).

Both take optional leading batch dimensions: ``sel (..., L, S)`` (or
packed ``(..., L, W)`` int32 words), one cursor set per batch entry.

The ``*_frames`` variants take a batch of frames in one of the two
survivor-stream layouts the split kernel writes (kernels/packing.Layout):
frame-major ``lane`` streams go through the batched functions above, and
``sublane`` streams (frames on the trailing axis) are chased directly with
the frame axis vectorised, so the stream is never transposed. They are the
plain version of the split path's traceback kernel
(kernels/csrc/traceback_frames.cu).
"""
from __future__ import annotations

import torch

from ..kernels.packing import Layout, extract_bit, packed_width
from .trellis import Trellis

__all__ = ["serial_traceback", "parallel_traceback",
           "serial_traceback_frames", "parallel_traceback_frames"]


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


def _sel_stages(sel: torch.Tensor, trellis: Trellis,
                packed: bool) -> torch.Tensor:
    """Sublane stream -> (L, W|S, F) stage-major int32 view (packed rows
    are stored flat as (L*W, F))."""
    sel = sel.to(torch.int32)
    if packed:
        return sel.reshape(-1, packed_width(trellis.num_states),
                           sel.shape[-1])
    return sel


def serial_traceback_frames(sel: torch.Tensor, amax: torch.Tensor,
                            trellis: Trellis, v1: int, f: int,
                            packed: bool = False,
                            layout: Layout = Layout.LANE) -> torch.Tensor:
    """Serial traceback of a frame batch -> (F, f) int32 bits.

    sel: lane (F, L, S|W); sublane (L*W, F) packed / (L, S, F) unpacked.
    amax: (F, L); the chase starts from each frame's last-stage argmax."""
    if Layout(layout) is Layout.LANE:
        return serial_traceback(sel, trellis, amax[:, -1], v1, f,
                                packed=packed)
    sel3 = _sel_stages(sel, trellis, packed)          # (L, W|S, F)
    L, _, F = sel3.shape
    kshift = trellis.k - 2
    S = trellis.num_states
    states = amax[:, -1].to(torch.int32)              # (F,)
    cols = torch.arange(F, device=sel.device)
    bits = [None] * L
    for t in range(L - 1, -1, -1):
        bits[t] = states >> kshift
        if packed:
            p = extract_bit(sel3[t], states, Layout.SUBLANE)
        else:
            p = sel3[t][states.to(torch.long), cols]
        states = ((states << 1) & (S - 1)) | p        # butterfly arithmetic
    return torch.stack(bits[v1:v1 + f], -1).to(torch.int32)


def parallel_traceback_frames(sel: torch.Tensor, amax: torch.Tensor,
                              trellis: Trellis, v1: int, f: int, f0: int,
                              v2s: int, start: str = "boundary",
                              packed: bool = False,
                              layout: Layout = Layout.LANE) -> torch.Tensor:
    """Parallel traceback of a frame batch -> (F, f) int32 bits.

    sel: lane (F, L, S|W); sublane (L*W, F) packed / (L, S, F) unpacked.
    amax: (F, L). In the sublane layout all nsub cursors of all F frames
    advance in lock-step with frames on the trailing axis."""
    if Layout(layout) is Layout.LANE:
        return parallel_traceback(sel, amax, trellis, v1, f, f0, v2s, start,
                                  packed=packed)
    if f % f0 != 0:
        raise ValueError("f must be a multiple of f0 (paper §IV-E alignment)")
    nsub = f // f0
    sel3 = _sel_stages(sel, trellis, packed)          # (L, W|S, F)
    F = sel3.shape[-1]
    dev = sel.device
    kshift = trellis.k - 2
    S = trellis.num_states

    e = v1 + (torch.arange(nsub, device=dev) + 1) * f0 - 1 + v2s  # (nsub,)
    if start == "boundary":
        states = amax[:, e].T.to(torch.int32)         # (nsub, F)
    elif start == "fixed":
        states = torch.zeros((nsub, F), dtype=torch.int32, device=dev)
    else:
        raise ValueError(start)
    ids = torch.arange(S, dtype=torch.int32, device=dev)[None, :, None]

    bits = []
    for r in range(f0 + v2s):
        rows = sel3[e - r]                            # (nsub, W|S, F)
        bits.append(states >> kshift)
        if packed:
            p = extract_bit(rows, states, Layout.SUBLANE)
        else:                                         # one-hot sum, exact
            p = (rows * (states[:, None, :] == ids)).sum(1, dtype=torch.int32)
        states = ((states << 1) & (S - 1)) | p
    kept = torch.stack(bits[v2s:][::-1])              # (f0, nsub, F) ascending
    return kept.permute(2, 1, 0).reshape(F, f).to(torch.int32)
