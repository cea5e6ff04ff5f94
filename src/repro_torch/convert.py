"""Carry state across from the JAX package.

A decoder has no weights: its state is the trellis and the
``DecoderConfig``/``FrameSpec``. ``config_from_dict`` reads the JSON-ready
dict that the JAX package's ``serve.checkpoint.encode_cfg`` writes and
returns the port's ``DecoderConfig``; the trellis is rebuilt from its
(k, polys) recipe, as the JAX package's ``decode_cfg`` does.

The LM scaffold has weights. ``lm_params_from_jax`` takes the pytree that
the JAX package's ``build_model(cfg).init`` returns, as numpy arrays, and
returns the port's ``Params``; ``lm_cache_from_jax`` does the same for a
decode cache, ``lm_opt_state_from_jax`` for AdamW's state. The JAX
package stacks each superblock position ``b<i>``'s layers along a
leading repeat axis R; the port keeps one entry per layer, in layer
order, so layer ``r*SB + i`` gets ``b<i>``'s slice ``r``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .configs.base import ModelConfig
from .core.framed import FrameSpec
from .core.pipeline import DecoderConfig
from .core.trellis import make_trellis
from .models.layers import Params
from .models.transformer import superblock_kinds

__all__ = ["config_from_dict", "CFG_FIELDS", "lm_params_from_jax",
           "lm_opt_state_from_jax", "lm_cache_from_jax"]

#: DecoderConfig's plain (JSON-native) fields; trellis and spec are
#: handled structurally (the JAX package's serve/checkpoint._CFG_FIELDS).
CFG_FIELDS = ("rate", "backend", "interpret", "pack_survivors", "radix",
              "frames_per_tile", "layout", "bm_dtype", "renorm_every",
              "block_frames", "overlap")


def config_from_dict(d: dict) -> DecoderConfig:
    """``encode_cfg`` dict -> the port's DecoderConfig. Fields absent from
    older dicts take the dataclass default."""
    trellis = make_trellis(int(d["trellis"]["k"]),
                           tuple(int(p) for p in d["trellis"]["polys"]))
    return DecoderConfig(trellis=trellis, spec=FrameSpec(**d["spec"]),
                         **{f: d[f] for f in CFG_FIELDS if f in d})


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included) -> a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _params(tree: dict, device, r=None) -> Params:
    """A nested dict of arrays -> ``Params``; ``r`` takes slice r of every
    leaf (one layer of a stacked stack)."""
    return Params(**{k: _params(v, device, r) if isinstance(v, dict)
                     else _tensor(v if r is None else np.asarray(v)[r],
                                  device)
                     for k, v in tree.items()})


def lm_params_from_jax(params: dict, cfg: ModelConfig,
                       device="cpu") -> Params:
    """The JAX package's ``init`` pytree (numpy leaves) -> the port's."""
    if cfg.family == "encdec":
        return Params(
            embed=_params(params["embed"], device),
            enc=nn.ModuleList([_params(params["enc"], device, r)
                               for r in range(cfg.enc_layers)]),
            dec=nn.ModuleList([_params(params["dec"], device, r)
                               for r in range(cfg.num_layers)]),
            ln_enc=_tensor(params["ln_enc"], device),
            ln_f=_tensor(params["ln_f"], device))
    sb = len(superblock_kinds(cfg))
    blocks = params["blocks"]
    return Params(
        embed=_params(params["embed"], device),
        layers=nn.ModuleList([_params(blocks[f"b{l % sb}"], device, l // sb)
                              for l in range(cfg.num_layers)]),
        ln_f=_tensor(params["ln_f"], device))


def lm_opt_state_from_jax(opt_state: dict, cfg: ModelConfig,
                          device="cpu") -> dict:
    """The JAX package's AdamW state (numpy leaves; ``m`` and ``v`` shaped
    like the param tree) -> the port's: ``m`` and ``v`` keyed by the
    port's parameter names, unstacked as ``lm_params_from_jax`` unstacks,
    and ``step`` a tensor."""
    def moments(tree):
        return {n: t.detach() for n, t in lm_params_from_jax(
            tree, cfg, device).named_parameters()}
    return {"m": moments(opt_state["m"]), "v": moments(opt_state["v"]),
            "step": _tensor(opt_state["step"], device)}


def _cache_entry(tree: dict, r: int, device) -> dict:
    return {k: int(np.asarray(v)[r]) if k == "idx"
            else _tensor(np.asarray(v)[r], device)
            for k, v in tree.items()}


def lm_cache_from_jax(cache: dict, cfg: ModelConfig, device="cpu") -> list:
    """The JAX package's decode cache (numpy leaves) -> the port's list of
    per-layer dicts (an attention cache's ``idx`` becomes an int)."""
    if cfg.family == "encdec":
        return [_cache_entry(cache, r, device)
                for r in range(cfg.num_layers)]
    sb = len(superblock_kinds(cfg))
    return [_cache_entry(cache[f"b{l % sb}"], l // sb, device)
            for l in range(cfg.num_layers)]
