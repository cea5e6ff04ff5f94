"""Trellis tables for the ACS recursion (port of ``repro.kernels.tables``).

Pallas cannot capture array constants, so the JAX package rebuilds these
tables inside its kernels from iota. Here they are built once on the host,
in numpy, from the same static ints (k, polys); the plain torch version
and the CUDA kernel receive them as small tensors (see
``viterbi_unified.device_tables``).
"""
from __future__ import annotations

import numpy as np

from ..core.trellis import Trellis

__all__ = ["kernel_tables", "radix4_tables"]


def _parity(x: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros_like(x)
    for b in range(k):
        out = out ^ ((x >> b) & 1)
    return out


def kernel_tables(trellis: Trellis):
    """Returns (prev [(S,) x2], bm_idx_p [(S,) x2], bm_sgn_p [(S,) x2],
    signs_half (half, beta)).

    prev_p(j) = ((j << 1) & (S-1)) | p is the butterfly predecessor; idx/sgn
    address the symmetry-compressed 2^(beta-1) branch-metric table
    (eqs. 8-9): bm of edge p into j = sgn_p[j] * bm_half[idx_p[j]].
    """
    k, beta, polys = trellis.k, trellis.beta, trellis.polys
    S = 1 << (k - 1)
    half = 1 << (beta - 1)
    mask = (1 << beta) - 1
    j = np.arange(S, dtype=np.int32)
    binput = j >> (k - 2)

    prev, idx_p, sgn_p = [], [], []
    for p in (0, 1):
        prev_p = ((j << 1) & (S - 1)) | p
        w = (binput << (k - 1)) | prev_p
        oword = np.zeros_like(j)
        for bi, g in enumerate(polys):
            oword = oword | (_parity(w & g, k) << (beta - 1 - bi))
        prev.append(prev_p)
        idx_p.append(np.where(oword < half, oword, mask ^ oword)
                     .astype(np.int32))
        sgn_p.append(np.where(oword < half, 1.0, -1.0).astype(np.float32))

    o = np.arange(half, dtype=np.int32)[:, None]
    bi = np.arange(beta, dtype=np.int32)[None, :]
    signs_half = (1.0 - 2.0 * ((o >> (beta - 1 - bi)) & 1)).astype(np.float32)
    return prev, idx_p, sgn_p, signs_half


def radix4_tables(trellis: Trellis):
    """Tables for the fused two-stage (radix-4) pair step:
    ``idx2[st][p] = idx_p[p] + st*half`` addresses the two stages' BM rows
    laid side by side; both half-steps share ``prev`` and ``sgn``."""
    half = 1 << (trellis.beta - 1)
    prev, idx_p, sgn_p, signs_half = kernel_tables(trellis)
    idx2 = [[idx_p[p] + st * half for p in (0, 1)] for st in (0, 1)]
    sgn2 = [[sgn_p[p] for p in (0, 1)] for st in (0, 1)]
    return prev, idx2, sgn2, signs_half
