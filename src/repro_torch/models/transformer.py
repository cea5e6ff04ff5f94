"""Decoder-only LM assembly: dense / MoE / SSM / hybrid / VLM; port of
``repro.models.transformer``.

The layer pattern (attention-vs-mamba x dense-vs-MoE) repeats with period
SB = lcm(|block_pattern|, moe.period) (``superblock_kinds``). The JAX
package stacks each superblock position's layers and scans over the R
repeats; the port keeps its layers in an ``nn.ModuleList`` in layer
order (layer ``r*SB + i`` has kind ``i``) and loops over it. The decode
cache is a list in the same order.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..distributed import ctx
from . import layers as L
from .layers import Params
from .moe import init_moe, moe_ff
from .ssm import init_mamba, init_mamba_state, mamba_decode, mamba_forward

__all__ = ["superblock_kinds", "init_params", "forward", "init_cache",
           "decode_step"]


def superblock_kinds(cfg: ModelConfig) -> list:
    """[(mixer 'A'|'M', ff 'dense'|'moe'|None), ...] for one superblock."""
    pat = cfg.pattern
    period = cfg.moe.period if cfg.moe else 1
    sb = math.lcm(len(cfg.block_pattern), period)
    assert cfg.num_layers % sb == 0, (cfg.num_layers, sb)
    kinds = []
    for i in range(sb):
        if cfg.d_ff == 0 and not cfg.moe_at(i):
            ff = None
        else:
            ff = "moe" if cfg.moe_at(i) else "dense"
        kinds.append((pat[i], ff))
    return kinds


def layer_kinds(cfg: ModelConfig) -> list:
    """Every layer's kind, in layer order."""
    kinds = superblock_kinds(cfg)
    return [kinds[i % len(kinds)] for i in range(cfg.num_layers)]


def _init_block(gen, cfg: ModelConfig, kind) -> Params:
    mixer, ff = kind
    p = {"ln1": L.ones((cfg.d_model,), gen),
         "mixer": (L.init_attention(gen, cfg) if mixer == "A"
                   else init_mamba(gen, cfg))}
    if ff is not None:
        p["ln2"] = L.ones((cfg.d_model,), gen)
        p["ff"] = init_moe(gen, cfg) if ff == "moe" else L.init_mlp(gen, cfg)
    return Params(**p)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights drawn from ``gen`` on its device."""
    return Params(
        embed=L.init_embed(gen, cfg),
        layers=nn.ModuleList([_init_block(gen, cfg, kind)
                              for kind in layer_kinds(cfg)]),
        ln_f=L.ones((cfg.d_model,), gen))


def _apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig, kind,
                 positions: torch.Tensor):
    mixer, ff = kind
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if mixer == "A":
        x = x + L.attention(p["mixer"], h, cfg, positions)
    else:
        x = x + mamba_forward(p["mixer"], h, cfg)
    if ff is not None:
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if ff == "moe":
            y, aux = moe_ff(p["ff"], h, cfg)
            x = x + y
        else:
            x = x + L.mlp(p["ff"], h)
    return x, aux


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            vision_embeds: Optional[torch.Tensor] = None,
            remat: str = "full"):
    """tokens (B, S) -> (hidden (B, S, d), moe_aux). Train/prefill path.
    ``remat`` applies to each superblock's layers as one unit, as the JAX
    package's scan body (``layers.rematerialized``)."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    if cfg.vision_patches and vision_embeds is not None:
        # early fusion: the first vision_patches positions are patch embeds
        Pv = cfg.vision_patches
        x = torch.cat([vision_embeds.to(x.dtype), x[:, Pv:]], dim=1)
    positions = torch.arange(S, device=x.device).expand(B, S)
    kinds = superblock_kinds(cfg)
    layers = params["layers"]

    def sb_body(x, first):
        x = ctx.constrain_batch(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(kinds):
            x, a = _apply_block(layers[first + i], x, cfg, kind, positions)
            aux = aux + a
        return x, aux

    body = L.rematerialized(sb_body, remat)
    auxs = []
    for first in range(0, cfg.num_layers, len(kinds)):
        x, aux = body(x, first)
        auxs.append(aux)
    x = ctx.constrain_batch(L.rms_norm(x, params["ln_f"], cfg.norm_eps))
    return x, torch.stack(auxs).sum()


# ------------------------------------------------------------- decoding ----
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> list:
    """One cache per layer, in layer order: attention {'k','v': (batch,
    max_seq, KV, hd), 'idx': int}, mamba {'conv', 'ssm'}."""
    KV, hd = cfg.num_kv_heads, cfg.hd

    def one(kind):
        if kind[0] == "A":
            shape = (batch, max_seq, KV, hd)
            return {"k": torch.zeros(shape, dtype=cfg.param_dtype,
                                     device=device),
                    "v": torch.zeros(shape, dtype=cfg.param_dtype,
                                     device=device),
                    "idx": 0}
        return init_mamba_state(cfg, batch, device=device)

    return [one(kind) for kind in layer_kinds(cfg)]


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: list):
    """One-token decode: tokens (B, 1) -> (logits (B, 1, V), new cache).
    Attention caches are written in place."""
    x = L.embed(params["embed"], tokens)
    newcache = []
    for p, (mixer, ff), c in zip(params["layers"], layer_kinds(cfg), cache):
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        if mixer == "A":
            y, c = L.attention_decode(p["mixer"], h, cfg, c)
        else:
            y, c = mamba_decode(p["mixer"], h, cfg, c)
        newcache.append(c)
        x = x + y
        if ff is not None:
            h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
            if ff == "moe":
                y, _ = moe_ff(p["ff"], h, cfg)
                x = x + y
            else:
                x = x + L.mlp(p["ff"], h)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.logits(params["embed"], x), newcache
