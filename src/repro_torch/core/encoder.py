"""Convolutional encoder (paper §II-A, Fig. 1a); port of ``repro.core.encoder``.

The JAX package scans the FSM. Each coded bit is a parity of the current
and the k-1 previous inputs, so here it is computed for all stages at once:
out_b[t] = XOR_i g_b[k-1-i] & in[t-i], with the initial state supplying
in[-1..-(k-1)]. The result equals the scan bit for bit (tests hold it
against ``encode_bits`` and the JAX encoder).
"""
from __future__ import annotations

import numpy as np
import torch

from .trellis import Trellis

__all__ = ["encode", "encode_bits"]


def encode(bits: torch.Tensor, trellis: Trellis,
           init_state: int = 0) -> torch.Tensor:
    """Encode ``bits`` (n,) {0,1} -> (n, beta) int32 coded bits."""
    k = trellis.k
    bits = bits.to(torch.int32)
    n = bits.shape[0]
    # history[k-1 + t] = in[t]; history[k-1-i] = in[-i] from the init state
    # (state bit k-1-i holds in[-i], MSB = newest)
    init = [(init_state >> (k - 1 - i)) & 1 for i in range(k - 1, 0, -1)]
    history = torch.cat([torch.tensor(init, dtype=torch.int32,
                                      device=bits.device), bits])
    cols = []
    for g in trellis.polys:
        acc = torch.zeros(n, dtype=torch.int32, device=bits.device)
        for i in range(k):                   # word bit k-1-i holds in[t-i]
            if (g >> (k - 1 - i)) & 1:
                acc = acc ^ history[k - 1 - i:k - 1 - i + n]
        cols.append(acc)
    return torch.stack(cols, dim=1)


def encode_bits(bits: np.ndarray, trellis: Trellis) -> np.ndarray:
    """Numpy reference encoder (test oracle for ``encode``)."""
    state = 0
    out = np.zeros((len(bits), trellis.beta), dtype=np.int32)
    for t, b in enumerate(np.asarray(bits, dtype=np.int64)):
        word = int(trellis.out_bits[state, b])
        for bi in range(trellis.beta):
            out[t, bi] = (word >> (trellis.beta - 1 - bi)) & 1
        state = int(trellis.next_state[state, b])
    return out
