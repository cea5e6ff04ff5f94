"""Model/config dataclasses + registry for the assigned architectures:
port of ``repro.configs.base``. The same fields and widths; ``param_dtype``
is a ``torch.dtype``."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

__all__ = ["MoESpec", "SSMSpec", "ModelConfig", "ShapeSpec", "SHAPES",
           "get_config", "ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    period: int = 1            # MoE every `period`-th layer (others dense)
    shared_expert: bool = False  # parallel dense expert (llama4-style)
    capacity_per_choice: float = 2.0   # per-top-1-slice capacity factor
    group_size: int = 512      # routing group (dispatch memory knob)


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    ngroups: int = 1
    d_conv: int = 4
    chunk: int = 256           # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense|moe|ssm|hybrid|encdec|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // num_heads
    rope_theta: float = 1e4
    qk_norm: bool = False
    qkv_bias: bool = False
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    # layer pattern, tiled to num_layers: 'A' = attention, 'M' = mamba
    block_pattern: tuple = ("A",)
    enc_layers: int = 0        # >0 -> encoder-decoder (num_layers = decoder)
    vision_patches: int = 0    # >0 -> early-fusion patch-embedding stub
    audio_frontend: bool = False   # encoder input is precomputed frames
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    vocab_round: int = 256     # pad vocab to a multiple (mesh divisibility)
    tie_embeddings: bool = False
    attn_chunk: int = 1024     # blockwise-attention q/kv chunk (flash-style)
    sub_quadratic: bool = False  # supports long_500k (SSM/hybrid)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round
        return -(-self.vocab // r) * r

    @property
    def param_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def pattern(self) -> tuple:
        reps = -(-self.num_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.num_layers]

    def moe_at(self, layer_idx: int) -> bool:
        return self.moe is not None and (layer_idx % self.moe.period
                                         == self.moe.period - 1)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "mamba2_2p7b", "phi3_vision_4p2b", "llama4_maverick_400b",
    "qwen3_moe_235b", "internlm2_20b", "starcoder2_7b", "qwen3_32b",
    "qwen15_32b", "seamless_m4t_v2", "jamba15_large",
]


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    """Load ``src/repro_torch/configs/<arch>.py`` and return its config."""
    arch = arch.replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.reduced() if reduced else mod.config()
