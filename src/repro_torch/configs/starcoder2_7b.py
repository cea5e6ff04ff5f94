"""starcoder2-7b [dense] — GQA + RoPE. 32L d_model=4608 36H (kv=4)
d_ff=18432 vocab=49152. [arXiv:2402.19173]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense", num_layers=32, d_model=4608,
        num_heads=36, num_kv_heads=4, d_ff=18432, vocab=49152,
        qkv_bias=True, rope_theta=1e5,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-reduced", family="dense", num_layers=2, d_model=72,
        num_heads=6, num_kv_heads=2, d_ff=144, vocab=193, vocab_round=8,
        qkv_bias=True,
    )
