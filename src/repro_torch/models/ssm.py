"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060); port of
``repro.models.ssm``.

Recurrence (per head h, state size N, head dim P):
    h_t = exp(a_t) * h_{t-1} + dt_t * B_t x_t^T        h_t: (N, P)
    y_t = C_t @ h_t + D * x_t                          a_t = dt_t * A  (<0)

The full-sequence forward is the chunked dual form: a loop over chunks of
length Q; inside a chunk the quadratic (Q x Q) form with the decay
``exp(cs_i - cs_j)``, across chunks only the (H, N, P) states flow. A
sequence that is not a multiple of Q is padded at the tail (causal, so
the padding is harmless) and cut after. Decode carries (conv_state,
ssm_state). State math in fp32; projections in cfg.dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed import ctx
from .layers import Params, init_normal, ones, rms_norm, zeros

__all__ = ["init_mamba", "mamba_forward", "mamba_decode", "init_mamba_state"]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.headdim
    return s, d_in, H, s.ngroups, s.d_state


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Params:
    s, d_in, H, G, N = _dims(cfg)
    conv_ch = d_in + 2 * G * N
    dt = cfg.param_dtype
    return Params(
        in_proj=init_normal(gen, (cfg.d_model, 2 * d_in + 2 * G * N + H),
                            dt),
        conv_w=init_normal(gen, (s.d_conv, conv_ch), dt),
        conv_b=zeros((conv_ch,), gen, dt),
        A_log=zeros((H,), gen),                          # A = -exp(0) = -1
        D=ones((H,), gen),
        dt_bias=zeros((H,), gen),
        norm_w=ones((d_in,), gen),
        out_proj=init_normal(gen, (d_in, cfg.d_model), dt))


def _split_proj(proj, cfg):
    s, d_in, H, G, N = _dims(cfg)
    return torch.split(proj, [d_in, d_in + 2 * G * N, H], dim=-1)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width K: (B,S,C) -> (B,S,C)."""
    K = w.shape[0]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + xBC.shape[1], :] * w[i] for i in range(K))
    return F.silu(out + b)


def _split_xbc(xBC, cfg):
    s, d_in, H, G, N = _dims(cfg)
    x, Bm, Cm = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    x = ctx.unflatten(x, -1, (H, s.headdim))
    # broadcast groups to heads
    rep = H // G
    Bm = ctx.unflatten(Bm, -1, (G, N)).repeat_interleave(rep, dim=2)
    Cm = ctx.unflatten(Cm, -1, (G, N)).repeat_interleave(rep, dim=2)
    return x, Bm, Cm


def _ssd_scan(x, Bm, Cm, a, dt, Q: int):
    """The chunked dual form over whole chunks of length Q: x (B,S,H,P),
    Bm/Cm (B,S,H,N), a/dt (B,S,H) -> y (B,S,H,P) in fp32, without the D
    skip. Each batch row and head is computed alone."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // Q
    xc = x.reshape(B, nc, Q, H, P).float()
    Bc = Bm.reshape(B, nc, Q, H, N).float()
    Cc = Cm.reshape(B, nc, Q, H, N).float()
    ac = a.reshape(B, nc, Q, H)
    dtc = dt.reshape(B, nc, Q, H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.float32,
                                device=x.device))

    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xq, bq, cq, aq, dq = (xc[:, c], Bc[:, c], Cc[:, c], ac[:, c],
                              dtc[:, c])
        cs = torch.cumsum(aq, dim=1)                    # (B,Q,H) inclusive
        # intra-chunk: decay(j->i) = exp(cs_i - cs_j), i >= j
        dec = torch.exp(cs[:, :, None, :] - cs[:, None, :, :])  # (B,Q,Q,H)
        dec = dec * tri[None, :, :, None]
        cb = torch.einsum("bihn,bjhn->bijh", cq, bq)
        scores = cb * dec * dq[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", scores, xq)
        # inter-chunk: contribution of the carried state
        y = y + torch.einsum("bihn,bhnp->bihp", cq * torch.exp(cs)[..., None],
                             state)
        # S' = exp(cs_last) S + sum_j exp(cs_last - cs_j) dt_j B_j x_j
        w = torch.exp(cs[:, -1:, :] - cs) * dq          # (B,Q,H)
        ns = torch.einsum("bjhn,bjhp->bhnp", bq * w[..., None], xq)
        state = state * torch.exp(cs[:, -1])[:, :, None, None] + ns
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, P)


def mamba_forward(p: Params, u: torch.Tensor, cfg: ModelConfig):
    """Full-sequence forward: u (B, S, d_model) -> (B, S, d_model)."""
    s, _, H, _, _ = _dims(cfg)
    S0 = u.shape[1]
    Q = min(s.chunk, S0)
    if S0 % Q:                        # causal => tail padding is harmless
        u = F.pad(u, (0, 0, 0, Q - S0 % Q))

    proj = ctx.pin_grad(u @ p["in_proj"])
    z, xBC, dt_raw = _split_proj(proj, cfg)
    b = ctx.get_batch_axes()
    ch = ctx.model_axes(xBC.shape[-1])
    xBC = ctx.local(_causal_conv, [(xBC, {0: b, 2: ch}, None),
                                   (p["conv_w"], {1: ch}, b),
                                   (p["conv_b"], {0: ch}, b)],
                    [({0: b, 2: ch}, None)])
    x, Bm, Cm = _split_xbc(xBC, cfg)                    # (B,S,H,P),(B,S,H,N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])       # (B,S,H)
    A = -torch.exp(p["A_log"])                          # (H,) negative
    a = dt * A                                          # (B,S,H) log-decay

    # local to a (batch row, head): on a mesh it runs on each rank's rows
    # and heads
    lay = {0: b, 2: ctx.model_axes(H)}
    y = ctx.local(lambda *t: _ssd_scan(*t, Q=Q),
                  [(t, lay, None) for t in (x, Bm, Cm, a, dt)],
                  [(lay, None)])                        # (B,S,H,P) fp32
    y = y + x.float() * p["D"][:, None]
    y = ctx.flatten(y, 2).to(u.dtype)

    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, :S0]


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cuda") -> dict:
    s, d_in, H, G, N = _dims(cfg)
    conv_ch = d_in + 2 * G * N
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch),
                            dtype=cfg.param_dtype, device=device),
        "ssm": torch.zeros((batch, H, N, s.headdim), dtype=dtype,
                           device=device),
    }


def _conv_step(hist, w, b):
    """The causal conv at the newest position: hist (B,K,C) -> (B,1,C)."""
    return F.silu(torch.einsum("bkc,kc->bc", hist, w) + b)[:, None, :]


def _ssm_step(ssm, xs, Bs, Cs, dt, A_log, D):
    """One step of the state recurrence per (row, head): (y (B,H,P),
    new state (B,H,N,P))."""
    a = torch.exp(dt * -torch.exp(A_log))               # (B,H)
    ssm = ssm * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bs * dt[..., None], xs)
    y = torch.einsum("bhn,bhnp->bhp", Cs, ssm) + xs * D[:, None]
    return y, ssm


def mamba_decode(p: Params, u: torch.Tensor, cfg: ModelConfig, state: dict):
    """One-token decode: u (B, 1, d_model); O(1) state, no KV growth. On a
    mesh the conv runs on each rank's rows and channels and the state
    update on its rows and heads, as the state is laid out by
    ``cache_specs``."""
    H = _dims(cfg)[2]
    proj = u @ p["in_proj"]
    z, xBC, dt_raw = _split_proj(proj, cfg)             # (B,1,*)
    # conv over (cached d_conv-1 inputs | current)
    hist = torch.cat([state["conv"], xBC.to(state["conv"].dtype)], dim=1)
    b = ctx.get_batch_axes()
    ch = ctx.model_axes(hist.shape[-1])
    conv = ctx.local(_conv_step, [(hist, {0: b, 2: ch}, None),
                                  (p["conv_w"], {1: ch}, None),
                                  (p["conv_b"], {0: ch}, None)],
                     [({0: b, 2: ch}, None)])
    x, Bm, Cm = _split_xbc(conv, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])[:, 0]
    hx = ctx.model_axes(H)
    lay, heads = {0: b, 1: hx}, {0: hx}
    y, ssm = ctx.local(_ssm_step, [
        (state["ssm"], lay, None), (x[:, 0].float(), lay, None),
        (Bm[:, 0].float(), lay, None), (Cm[:, 0].float(), lay, None),
        (dt, lay, None), (p["A_log"], heads, None), (p["D"], heads, None)],
        [(lay, None), (lay, None)])
    y = ctx.flatten(y[:, None], 2).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], {"conv": hist[:, 1:], "ssm": ssm}
