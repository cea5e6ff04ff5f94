"""qwen3-32b [dense] — qk_norm + GQA. 64L d_model=5120 64H (kv=8)
d_ff=25600 vocab=151936. [hf:Qwen/Qwen3-*]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense", num_layers=64, d_model=5120,
        num_heads=64, num_kv_heads=8, d_ff=25600, vocab=151936,
        head_dim=128, qk_norm=True, rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-reduced", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=160, vocab=211, head_dim=16,
        qk_norm=True, vocab_round=8,
    )
