"""Reference full-sequence Viterbi decoder (paper Alg. 1 + Alg. 2); port of
``repro.core.decoder``.

The plain torch recursion every kernel of the port is held against. The
JAX package scans one sequence and vmaps over frames; here every function
takes optional leading batch dimensions, ``llr (..., n, beta)``, and runs
the stages in a Python loop.
"""
from __future__ import annotations

import torch

from .metrics import branch_metrics_half, expand_half
from .trellis import Trellis

__all__ = ["viterbi_forward", "viterbi_traceback", "viterbi_decode"]

NEG = -1e30   # "minus infinity" for the biased initial metrics


def viterbi_forward(llr: torch.Tensor, trellis: Trellis,
                    sigma0: torch.Tensor | None = None, radix: int = 2,
                    renorm_every: int = 1):
    """Alg. 1: ACS over all stages.

    Args:
      llr: (..., n, beta) soft inputs (zero entries are neutral).
      sigma0: optional (..., S) initial path metrics (default zeros).
      radix: 2 or 4. Radix 4 runs the same per-stage arithmetic two stages
        per step, so its outputs are identical to radix 2.
      renorm_every: subtract the stage max every N stages; 1 is every
        stage (what the kernels do), 0 never. N != 1 requires radix 2.

    Returns:
      sel:   (..., n, S) int8 selector bits (1 -> predecessor 2j+1).
      sigma: (..., S) final path metrics.
      amax:  (..., n) int32 argmax state per stage (first maximal state).
    """
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    if renorm_every < 0:
        raise ValueError(f"renorm_every must be >= 0, got {renorm_every}")
    if renorm_every != 1 and radix != 2:
        raise ValueError("renorm_every != 1 requires radix=2 (reference)")
    dev = llr.device
    S = trellis.num_states
    prev_state = torch.as_tensor(trellis.prev_state, dtype=torch.long,
                                 device=dev)
    prev_out = torch.as_tensor(trellis.prev_out, dtype=torch.long, device=dev)
    bm = expand_half(branch_metrics_half(llr, trellis), trellis)  # (..., n, 2^b)
    n = bm.shape[-2]
    if sigma0 is None:
        sigma = torch.zeros((*llr.shape[:-2], S), dtype=torch.float32,
                            device=dev)
    else:
        sigma = sigma0.to(torch.float32).expand(*llr.shape[:-2], S)
    sels, amaxs = [], []
    # radix 4 pairs stages (t, t+1) with the exact radix-2 step for each,
    # plus an odd-length tail; a flat stage loop performs that sequence
    for t in range(n):
        bmt = bm[..., t, :]
        cand0 = sigma[..., prev_state[:, 0]] + bmt[..., prev_out[:, 0]]
        cand1 = sigma[..., prev_state[:, 1]] + bmt[..., prev_out[:, 1]]
        sel = cand1 >= cand0                          # ties -> 2j+1
        new = torch.where(sel, cand1, cand0)
        if renorm_every and t % renorm_every == renorm_every - 1:
            new = new - new.max(dim=-1, keepdim=True).values
        sigma = new
        sels.append(sel.to(torch.int8))
        amaxs.append(torch.argmax(new, dim=-1))
    return (torch.stack(sels, dim=-2), sigma,
            torch.stack(amaxs, dim=-1).to(torch.int32))


def viterbi_traceback(sel: torch.Tensor, trellis: Trellis,
                      start_state: torch.Tensor):
    """Alg. 2: serial traceback from ``start_state`` (...) over all of
    ``sel`` (..., n, S). Returns (bits, states), each (..., n): bits[t] is
    the decoded input bit of stage t, states[t] the survivor state at t."""
    prev_state = torch.as_tensor(trellis.prev_state, dtype=torch.long,
                                 device=sel.device)
    kshift = trellis.k - 2
    j = torch.as_tensor(start_state, device=sel.device).to(torch.long)
    n = sel.shape[-2]
    bits, states = [None] * n, [None] * n
    for t in range(n - 1, -1, -1):
        bits[t] = j >> kshift
        states[t] = j
        p = torch.gather(sel[..., t, :].to(torch.long), -1,
                         j[..., None])[..., 0]
        j = prev_state[j, p]
    return (torch.stack(bits, -1).to(torch.int32),
            torch.stack(states, -1).to(torch.int32))


def viterbi_decode(llr: torch.Tensor, trellis: Trellis,
                   radix: int = 2) -> torch.Tensor:
    """Full-sequence decode: (n, beta) llr -> (n,) int32 bits."""
    S = trellis.num_states
    sigma0 = torch.full((S,), NEG, dtype=torch.float32, device=llr.device)
    sigma0[0] = 0.0                    # the encoder starts in state 0
    sel, sigma, _ = viterbi_forward(llr, trellis, sigma0, radix)
    start = torch.argmax(sigma, dim=-1)
    bits, _ = viterbi_traceback(sel, trellis, start)
    return bits
