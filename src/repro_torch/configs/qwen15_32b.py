"""qwen1.5-32b [dense] — QKV bias, MHA-heavy GQA (kv=40). 64L d_model=5120
40H d_ff=27392 vocab=152064. [hf:Qwen/Qwen1.5-*]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense", num_layers=64, d_model=5120,
        num_heads=40, num_kv_heads=40, d_ff=27392, vocab=152064,
        qkv_bias=True, rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen15-reduced", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab=211, vocab_round=8,
        qkv_bias=True,
    )
