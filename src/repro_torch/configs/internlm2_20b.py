"""internlm2-20b [dense] — GQA. 48L d_model=6144 48H (kv=8) d_ff=16384
vocab=92544. [arXiv:2403.17297]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense", num_layers=48, d_model=6144,
        num_heads=48, num_kv_heads=8, d_ff=16384, vocab=92544,
        rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internlm2-reduced", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab=157, vocab_round=8,
    )
