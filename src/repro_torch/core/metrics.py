"""Branch metrics (paper §II-B eq. 2, §IV-B); port of ``repro.core.metrics``.

delta_t(o) = sum_b (-1)^{o[b]} * llr_t[b] for an output word o. Only
2^(beta-1) magnitudes are distinct (eq. 9). The sum runs over b in order,
as the CUDA kernel sums it: the signs are ±1, so every product is exact
and the order of the additions alone fixes the result.
"""
from __future__ import annotations

import torch

from .trellis import Trellis

__all__ = ["branch_metrics_full", "branch_metrics_half", "expand_half",
           "signed_sum"]


def signed_sum(llr: torch.Tensor, signs) -> torch.Tensor:
    """(..., beta) llr, (H, beta) ±1 signs -> (..., H), summed over b in
    order in float32."""
    llr = llr.to(torch.float32)
    signs = torch.as_tensor(signs, dtype=torch.float32, device=llr.device)
    acc = llr[..., None, 0] * signs[:, 0]
    for b in range(1, signs.shape[1]):
        acc = acc + llr[..., None, b] * signs[:, b]
    return acc


def branch_metrics_full(llr: torch.Tensor, trellis: Trellis) -> torch.Tensor:
    """(n, beta) llr -> (n, 2^beta) metrics for every output word (eq. 7)."""
    return signed_sum(llr, trellis.out_signs)


def branch_metrics_half(llr: torch.Tensor, trellis: Trellis) -> torch.Tensor:
    """(n, beta) llr -> (n, 2^(beta-1)) compressed metrics (eqs. 8-9)."""
    return signed_sum(llr, trellis.out_signs[:1 << (trellis.beta - 1)])


def expand_half(bm_half: torch.Tensor, trellis: Trellis) -> torch.Tensor:
    """Reconstruct the full (.., 2^beta) table from the compressed half."""
    idx = torch.as_tensor(trellis.bm_index, dtype=torch.long,
                          device=bm_half.device)
    sgn = torch.as_tensor(trellis.bm_sign, device=bm_half.device
                          ).to(bm_half.dtype)
    return bm_half[..., idx] * sgn
