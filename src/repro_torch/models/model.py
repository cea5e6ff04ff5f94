"""Unified model API: build_model(cfg) -> ModelBundle; port of
``repro.models.model``.

Every architecture exposes the same entry points, which the serve loop
and the tests consume:

    init(gen)                      -> params   (gen: a torch.Generator)
    loss(params, batch)            -> scalar   (batch: tokens/labels/+extras)
    prefill(params, batch)         -> last_logits
    decode(params, tokens, cache)  -> (logits, cache)
    init_cache(params, batch, max_seq) -> cache

``device`` is where the bundle makes its weights and caches: ``None``
means ``"cuda"``, and without a card that raises unless ``"cpu"`` is
asked for. ``remat`` ("full", "dots" or "none") is what ``loss``'s
backward keeps and what it computes again, as in the JAX package
(``layers.rematerialized``); gradients do not depend on it. ``prefill``,
``decode`` and ``init_cache`` run without autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..kernels.ops import resolve_device
from . import encdec
from . import layers as L
from . import transformer as T

__all__ = ["ModelBundle", "build_model", "batch_spec"]

AUX_COEF = 0.01


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable          # (params, batch, max_seq) -> cache
    device: torch.device


def _lm_bundle(cfg: ModelConfig, remat: str, dev) -> ModelBundle:
    def init(gen):
        return T.init_params(gen, cfg)

    def loss(params, batch):
        x, aux = T.forward(params, cfg, batch["tokens"],
                           batch.get("vision_embeds"), remat=remat)
        lg = L.logits(params["embed"], x)
        return L.softmax_xent(lg, batch["labels"]) + AUX_COEF * aux

    @torch.no_grad()
    def prefill(params, batch):
        # forward over the full prompt; emit last-position logits
        x, _ = T.forward(params, cfg, batch["tokens"],
                         batch.get("vision_embeds"), remat=remat)
        return L.logits(params["embed"], x[:, -1:])

    @torch.no_grad()
    def init_cache(params, batch_size, max_seq):
        return T.init_cache(cfg, batch_size, max_seq, device=dev)

    @torch.no_grad()
    def decode(params, tokens, cache):
        return T.decode_step(params, cfg, tokens, cache)

    return ModelBundle(cfg, init, loss, prefill, decode, init_cache, dev)


def _encdec_bundle(cfg: ModelConfig, remat: str, dev) -> ModelBundle:
    def init(gen):
        return encdec.init_params(gen, cfg)

    def loss(params, batch):
        mem = encdec.encode(params, cfg, batch["frames"], remat=remat)
        x = encdec.decode_train(params, cfg, batch["tokens"], mem,
                                remat=remat)
        lg = L.logits(params["embed"], x)
        return L.softmax_xent(lg, batch["labels"])

    @torch.no_grad()
    def prefill(params, batch):
        mem = encdec.encode(params, cfg, batch["frames"], remat=remat)
        x = encdec.decode_train(params, cfg, batch["tokens"], mem,
                                remat=remat)
        return L.logits(params["embed"], x[:, -1:])

    @torch.no_grad()
    def init_cache(params, batch_size, max_seq, memory=None):
        if memory is None:
            memory = torch.zeros((batch_size, 128, cfg.d_model),
                                 dtype=cfg.param_dtype, device=dev)
        return encdec.init_cache(params, cfg, batch_size, max_seq, memory)

    @torch.no_grad()
    def decode(params, tokens, cache):
        return encdec.decode_step(params, cfg, tokens, cache)

    return ModelBundle(cfg, init, loss, prefill, decode, init_cache, dev)


def build_model(cfg: ModelConfig, remat: str = "full",
                device=None) -> ModelBundle:
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return _encdec_bundle(cfg, remat, dev)
    return _lm_bundle(cfg, remat, dev)


def batch_spec(cfg: ModelConfig, seq: int, batch: int, kind: str) -> dict:
    """Input structure for a (cfg, shape) cell: name -> (shape, dtype)."""
    if cfg.family == "encdec":
        if kind == "train" or kind == "prefill":
            return {"frames": ((batch, seq, cfg.d_model), torch.float32),
                    "tokens": ((batch, seq), torch.int32),
                    "labels": ((batch, seq), torch.int32)}
        return {"tokens": ((batch, 1), torch.int32)}
    spec = {"tokens": ((batch, seq if kind != "decode" else 1), torch.int32)}
    if kind == "train":
        spec["labels"] = ((batch, seq), torch.int32)
    if cfg.vision_patches and kind in ("train", "prefill"):
        spec["vision_embeds"] = ((batch, cfg.vision_patches, cfg.d_model),
                                 torch.float32)
    return spec
