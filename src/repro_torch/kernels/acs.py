"""Branch metrics + ACS recursion shared by the unified and split kernels
(port of ``repro.kernels.acs``).

Two forms of one recursion:

* ``acs_scan`` here: the plain torch version, parameterized by a
  ``store(t, sel, sigma)`` callback like the JAX original, so the plain
  versions of both kernels run one recursion.
* ``csrc/acs.cuh``: the same arithmetic as CUDA device functions, which the
  unified kernel and the split path's forward kernel include, so the
  kernels cannot drift apart.

The arithmetic, which the gate holds bit for bit:

* compressed branch metrics (eq. 9) ``bm[t,h] = sum_b signs_half[h,b] *
  llr[t,b]``, summed over b in order in float32, stored in ``bm_dtype``
  (bfloat16 rounds once, to nearest even) and read back as float32;
* per half-step, for p in {0, 1}: ``cand_p = sigma[perm_p] + sgn_p *
  bm[idx_p]``; ``sel = cand1 >= cand0`` (ties go to predecessor 1);
  ``sigma = where(sel, cand1, cand0)``; ``sigma -= max(sigma)`` at every
  stage;
* radix 4 is two exact radix-2 half-steps, with both stages' BM rows laid
  side by side and addressed by ``radix4_tables``' fused indices.

The JAX package also runs the recursion transposed (its ``layout`` knob,
a TPU orientation); the arithmetic is the same, so this runs (FT, S) only.
"""
from __future__ import annotations

import torch

from ..core.metrics import signed_sum
from ..core.trellis import Trellis
from .tables import kernel_tables, radix4_tables

__all__ = ["acs_scan", "BM_DTYPES"]

BM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def acs_scan(llr: torch.Tensor, *, trellis: Trellis, L: int, radix: int,
             store, bm_dtype: str = "float32"):
    """Branch metrics + ACS over all L stages of ``llr`` (FT, L, beta);
    calls ``store(t, sel, sigma)`` with (FT, S) tensors once per stage, in
    stage order, and returns the final (FT, S) sigma."""
    dev = llr.device
    S = trellis.num_states
    half = 1 << (trellis.beta - 1)
    FT = llr.shape[0]
    if radix == 4:
        perm, idx2, sgn2, signs_half = radix4_tables(trellis)
    elif radix == 2:
        perm, idx_p, sgn_p, signs_half = kernel_tables(trellis)
        idx2, sgn2 = [idx_p], [sgn_p]
    else:
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)
    as_f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    perm = [as_long(p) for p in perm]
    idx2 = [[as_long(i) for i in row] for row in idx2]
    sgn2 = [[as_f32(s) for s in row] for row in sgn2]

    bm = signed_sum(llr[:, :L], signs_half).to(BM_DTYPES[bm_dtype])  # (FT,L,h)

    def acs_half(sigma, bmr, st):                   # one radix-2 half-step
        cand = [sigma[:, perm[p]]
                + bmr[:, idx2[st][p]].to(torch.float32) * sgn2[st][p]
                for p in (0, 1)]
        sel = cand[1] >= cand[0]
        sigma = torch.where(sel, cand[1], cand[0])
        return sigma - sigma.max(dim=1, keepdim=True).values, sel

    sigma = torch.zeros((FT, S), dtype=torch.float32, device=dev)
    if radix == 4:
        for t in range(0, L - 1, 2):
            bm2 = bm[:, t:t + 2].reshape(FT, 2 * half)   # fused two-stage row
            for st in (0, 1):
                sigma, sel = acs_half(sigma, bm2, st)
                store(t + st, sel, sigma)
        if L % 2:                                   # odd-length tail stage
            sigma, sel = acs_half(sigma, bm[:, L - 1], 0)
            store(L - 1, sel, sigma)
        return sigma
    for t in range(L):
        sigma, sel = acs_half(sigma, bm[:, t], 0)
        store(t, sel, sigma)
    return sigma
