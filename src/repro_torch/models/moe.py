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
one by one and sum. On a mesh the expert buffers (E, G, C, ...) have
experts over 'model' (EP) and groups over the batch axes, as the JAX
package's ``_constrain_expert`` pins them (``moe_ff``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed import ctx
from .layers import Params, init_normal, mlp

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


def _route(rl, dtype, k: int, C1: int, n: int):
    """Top-k routing of the groups' router logits ``rl`` (G, g, E): the
    k dispatch one-hots (G, g, E, C1) in ``dtype``, their combine weights,
    the kept weight per token (G, g), and the load-balance statistics
    (E,) — the share of tokens whose top-1 is each expert and the mean
    router probability — each divided by ``n``, the number of group
    shards they are summed over."""
    G, g, E = rl.shape
    probs = torch.softmax(rl, dim=-1)
    top1 = probs.argmax(-1)
    frac = _one_hot(top1, E).mean(dim=(0, 1)) / n
    mprob = probs.mean(dim=(0, 1)) / n

    remaining = probs
    disp_k, comb_k = [], []
    wsum = torch.zeros((G, g), dtype=torch.float32, device=rl.device)
    for _ in range(k):                                   # top-k loop
        w_j, e_j = remaining.max(-1)                     # first maximum
        oh_e = _one_hot(e_j, E)                          # (G, g, E)
        remaining = remaining * (1.0 - oh_e)
        pos = torch.cumsum(oh_e, dim=1) - 1.0            # (G, g, E)
        pos_tok = torch.einsum("gte,gte->gt", pos, oh_e)
        keep = pos_tok < C1
        # a position past capacity one-hots to nothing (jax.nn.one_hot)
        oh_c = _one_hot(pos_tok.clamp(max=C1 - 1), C1) * keep[..., None]
        disp = torch.einsum("gte,gtc->gtec", oh_e, oh_c).to(dtype)
        disp_k.append(disp)                              # (G, g, E, C1)
        comb_k.append(disp * w_j[..., None, None].to(dtype))
        wsum = wsum + w_j * keep                         # dropped -> no w
    return (*disp_k, *comb_k, wsum, frac, mprob)


def _experts(disp, comb, xt, ewg, ewu, ewd):
    """Dispatch the groups' tokens to the experts, the gated FF of each,
    and combine: (G, g, d)."""
    xin = torch.einsum("gtec,gtd->egcd", disp, xt)       # (E, G, C, d)
    h = F.silu(torch.einsum("egcd,edf->egcf", xin, ewg))
    h = h * torch.einsum("egcd,edf->egcf", xin, ewu)
    yo = torch.einsum("egcf,efd->egcd", h, ewd)
    return torch.einsum("gtec,egcd->gtd", comb, yo)      # (G, g, d)


def moe_ff(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar).

    On a mesh, as the JAX package pins its expert buffers: groups over
    the batch axes but 'model' when they divide, and experts over 'model'
    when they divide (EP), under either strategy. The router product runs
    on each rank's groups and its experts' columns (the router's columns
    over 'model', as GSPMD splits it), the rest of the routing on each
    rank's groups with the logits whole, and the experts on their own
    tokens: each rank's partial sum of the combine is reduced over
    'model'. The weights' gradients come back as partial sums over the
    group axes."""
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
    axes = ctx.get_batch_axes()
    gax = tuple(a for a in (axes if isinstance(axes, tuple) else (axes,))
                if a not in (None, "model")) or None
    gax = ctx.even_axes(gax, G)
    eax = ctx.even_axes("model", E)
    grp = ({0: gax}, None)
    rl = ctx.local(lambda xt, r: xt.float() @ r,
                   [(xt, {0: gax}, eax), (p["router"], {1: eax}, gax)],
                   [({0: gax, 2: eax}, None)])            # (G, g, E)
    out = ctx.local(lambda rl: _route(rl, x.dtype, k, C1, ctx.shards(gax)),
                    [(rl, {0: gax}, None)],
                    [grp] * (2 * k + 1) + [({}, gax)] * 2)
    disp_k, comb_k = out[:k], out[k:2 * k]
    wsum, frac, mprob = out[2 * k:]
    # load-balance aux (Switch/GShard): E * mean_e(frac_tokens * mean_prob)
    aux = E * torch.sum(frac * mprob)

    def expert_ff(disp, comb):
        tok = {0: gax, 2: eax}
        return ctx.local(_experts, [
            (disp, tok, None), (comb, tok, None), (xt, {0: gax}, eax),
            (p["ewg"], {0: eax}, gax), (p["ewu"], {0: eax}, gax),
            (p["ewd"], {0: eax}, gax)], [({0: gax}, eax)])

    if T >= 4 * m.group_size:
        y = expert_ff(torch.cat(disp_k, dim=-1), torch.cat(comb_k, dim=-1))
    else:
        y = sum(expert_ff(d_, c_) for d_, c_ in zip(disp_k, comb_k))

    def normalize(y, wsum):             # each rank's groups -> its rows
        y = y / torch.clamp(wsum[..., None], min=1e-9).to(x.dtype)
        return y.reshape(-1, S, d)

    y = ctx.local(normalize, [(y, {0: gax}, None), (wsum, {0: gax}, None)],
                  [({0: gax}, None)])
    if m.shared_expert:
        y = y + mlp(p["shared"], x)
    return y, aux
