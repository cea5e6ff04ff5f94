"""Mixture-of-Experts FF layer (top-k routing, capacity-bounded dispatch);
port of ``repro.models.moe``.

Tokens are split into routing groups of ``group_size`` (the largest
divisor of the token count not above it); each of the k routing choices
is dispatched as a top-1 one-hot einsum with per-choice capacity
``C1 = ceil(group_size * capacity_per_choice / num_experts)``. Order of
operations as in the JAX package: the argmax takes the first maximum, a
chosen expert is zeroed by ``remaining * (1 - one_hot)``, capacity
positions come from a cumsum in token order, and a dropped choice adds no
weight to the renormalization. Large token counts (T >= 4 * group_size)
run the k dispatches fused along the capacity axis; smaller ones run them
one by one and sum. Without a mesh there is no expert sharding to pin.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import Params, init_normal

__all__ = ["init_moe", "moe_ff"]


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    m = cfg.moe
    d, E, ff = cfg.d_model, m.num_experts, m.d_ff_expert
    dt = cfg.param_dtype
    p = {"router": init_normal(gen, (d, E), torch.float32),
         "ewg": init_normal(gen, (E, d, ff), dt),
         "ewu": init_normal(gen, (E, d, ff), dt),
         "ewd": init_normal(gen, (E, ff, d), dt)}
    if m.shared_expert:
        p["shared"] = Params(wg=init_normal(gen, (d, ff), dt),
                             wu=init_normal(gen, (d, ff), dt),
                             wd=init_normal(gen, (ff, d), dt))
    return Params(**p)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(idx.long(), n).float()


def moe_ff(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    T = B * S
    g = min(m.group_size, T)
    while T % g:                      # largest divisor of T <= group_size
        g -= 1
    G = T // g
    C1 = max(1, int(-(-g * m.capacity_per_choice // E)))

    xt = x.reshape(G, g, d)
    rl = xt.float() @ p["router"]                        # (G, g, E)
    probs = torch.softmax(rl, dim=-1)

    # load-balance aux (Switch/GShard): E * mean_e(frac_tokens * mean_prob)
    top1 = probs.argmax(-1)
    frac = _one_hot(top1, E).mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))

    remaining = probs
    disp_k, comb_k = [], []
    wsum = torch.zeros((G, g), dtype=torch.float32, device=x.device)
    for _ in range(k):                                   # top-k loop
        w_j, e_j = remaining.max(-1)                     # first maximum
        oh_e = _one_hot(e_j, E)                          # (G, g, E)
        remaining = remaining * (1.0 - oh_e)
        pos = torch.cumsum(oh_e, dim=1) - 1.0            # (G, g, E)
        pos_tok = torch.einsum("gte,gte->gt", pos, oh_e)
        keep = pos_tok < C1
        # a position past capacity one-hots to nothing (jax.nn.one_hot)
        oh_c = _one_hot(pos_tok.clamp(max=C1 - 1), C1) * keep[..., None]
        disp = torch.einsum("gte,gtc->gtec", oh_e, oh_c).to(x.dtype)
        disp_k.append(disp)                              # (G, g, E, C1)
        comb_k.append(disp * w_j[..., None, None].to(x.dtype))
        wsum = wsum + w_j * keep                         # dropped -> no w

    def expert_ff(disp, comb):
        xin = torch.einsum("gtec,gtd->egcd", disp, xt)   # (E, G, C, d)
        h = F.silu(torch.einsum("egcd,edf->egcf", xin, p["ewg"]))
        h = h * torch.einsum("egcd,edf->egcf", xin, p["ewu"])
        yo = torch.einsum("egcf,efd->egcd", h, p["ewd"])
        return torch.einsum("gtec,egcd->gtd", comb, yo)  # (G, g, d)

    if T >= 4 * m.group_size:
        y = expert_ff(torch.cat(disp_k, dim=-1), torch.cat(comb_k, dim=-1))
    else:
        y = sum(expert_ff(d_, c_) for d_, c_ in zip(disp_k, comb_k))
    y = y / torch.clamp(wsum[..., None], min=1e-9).to(x.dtype)

    if m.shared_expert:
        sp = p["shared"]
        y = y + (F.silu(xt @ sp["wg"]) * (xt @ sp["wu"])) @ sp["wd"]
    return y.reshape(B, S, d), aux
