"""Encoder-decoder model (seamless-m4t); port of ``repro.models.encdec``:
a bidirectional encoder over precomputed frame embeddings (the audio
frontend is a stub) and a causal decoder with cross-attention. The
layers of each stack sit in an ``nn.ModuleList`` in order; the decode
cache is a list of one dict per decoder layer. Under any ``remat`` but
"none", each layer is rematerialized whole in the backward."""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..distributed import ctx
from . import layers as L
from .layers import Params

__all__ = ["init_params", "encode", "decode_train", "init_cache",
           "decode_step"]


def _init_enc_layer(gen, cfg):
    return Params(ln1=L.ones((cfg.d_model,), gen),
                  attn=L.init_attention(gen, cfg),
                  ln2=L.ones((cfg.d_model,), gen),
                  ff=L.init_mlp(gen, cfg))


def _init_dec_layer(gen, cfg):
    return Params(ln1=L.ones((cfg.d_model,), gen),
                  attn=L.init_attention(gen, cfg),
                  lnx=L.ones((cfg.d_model,), gen),
                  xattn=L.init_attention(gen, cfg, fused=False),
                  ln2=L.ones((cfg.d_model,), gen),
                  ff=L.init_mlp(gen, cfg))


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return Params(
        embed=L.init_embed(gen, cfg),
        enc=nn.ModuleList([_init_enc_layer(gen, cfg)
                           for _ in range(cfg.enc_layers)]),
        dec=nn.ModuleList([_init_dec_layer(gen, cfg)
                           for _ in range(cfg.num_layers)]),
        ln_enc=L.ones((cfg.d_model,), gen),
        ln_f=L.ones((cfg.d_model,), gen))


def _layer_remat(remat: str) -> str:
    """The JAX package checkpoints each encoder and decoder layer whole
    for any policy but "none"."""
    return "none" if remat == "none" else "full"


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           remat: str = "full") -> torch.Tensor:
    """frames: (B, S_enc, d_model) precomputed embeddings -> memory."""
    B, S, _ = frames.shape
    positions = torch.arange(S, device=frames.device).expand(B, S)
    x = frames.to(cfg.param_dtype)

    def body(x, p):
        x = ctx.constrain_batch(x)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + L.attention(p["attn"], h, cfg, positions, causal=False)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp(p["ff"], h)

    body = L.rematerialized(body, _layer_remat(remat))
    for p in params["enc"]:
        x = body(x, p)
    return L.rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _cross_kv(p, memory, cfg):
    B, Sm, _ = memory.shape
    KV, hd = cfg.num_kv_heads, cfg.hd
    k = ctx.unflatten(L._proj(memory, p["wk"], p.get("bk")), -1, (KV, hd))
    v = ctx.unflatten(L._proj(memory, p["wv"], p.get("bv")), -1, (KV, hd))
    return k, v


def decode_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 memory: torch.Tensor, remat: str = "full"):
    """Teacher-forced decoder pass -> hidden states (B, S, d)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = L.embed(params["embed"], tokens)

    def body(x, p):
        x = ctx.constrain_batch(x)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + L.attention(p["attn"], h, cfg, positions, causal=True)
        h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
        kv = _cross_kv(p["xattn"], memory, cfg)
        x = x + L.attention(p["xattn"], h, cfg, positions, kv_override=kv)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp(p["ff"], h)

    body = L.rematerialized(body, _layer_remat(remat))
    for p in params["dec"]:
        x = body(x, p)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps)


def init_cache(params: Params, cfg: ModelConfig, batch: int, max_seq: int,
               memory: torch.Tensor) -> list:
    """Self-attention KV cache + precomputed cross K/V per decoder
    layer."""
    KV, hd = cfg.num_kv_heads, cfg.hd
    shape = (batch, max_seq, KV, hd)
    cache = []
    for p in params["dec"]:
        xk, xv = _cross_kv(p["xattn"], memory, cfg)
        cache.append({"k": torch.zeros(shape, dtype=cfg.param_dtype,
                                       device=memory.device),
                      "v": torch.zeros(shape, dtype=cfg.param_dtype,
                                       device=memory.device),
                      "idx": 0, "xk": xk, "xv": xv})
    return cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: list):
    x = L.embed(params["embed"], tokens)
    newcache = []
    for p, c in zip(params["dec"], cache):
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        y, newc = L.attention_decode(p["attn"], h, cfg, c)
        x = x + y
        h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + L.attention(p["xattn"], h, cfg,
                            positions=torch.zeros(h.shape[:2],
                                                  dtype=torch.int32,
                                                  device=h.device),
                            kv_override=(c["xk"], c["xv"]))
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.mlp(p["ff"], h)
        newcache.append({**newc, "xk": c["xk"], "xv": c["xv"]})
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.logits(params["embed"], x), newcache
