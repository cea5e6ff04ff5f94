"""Carry a decoder configuration across from the JAX package.

A decoder has no weights: its state is the trellis and the
``DecoderConfig``/``FrameSpec``. ``config_from_dict`` reads the JSON-ready
dict that the JAX package's ``serve.checkpoint.encode_cfg`` writes and
returns the port's ``DecoderConfig``; the trellis is rebuilt from its
(k, polys) recipe, as the JAX package's ``decode_cfg`` does.
"""
from __future__ import annotations

from .core.framed import FrameSpec
from .core.pipeline import DecoderConfig
from .core.trellis import make_trellis

__all__ = ["config_from_dict", "CFG_FIELDS"]

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
