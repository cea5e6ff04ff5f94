"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, every layer.

94L d_model=4096 64H (GQA kv=4) moe d_ff=1536 vocab=151936, qk_norm.
[hf:Qwen/Qwen3-*]
"""
from .base import ModelConfig, MoESpec


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", num_layers=94,
        d_model=4096, num_heads=64, num_kv_heads=4, d_ff=1536, vocab=151936,
        head_dim=128, qk_norm=True, rope_theta=1e6,
        moe=MoESpec(num_experts=128, top_k=8, d_ff_expert=1536, period=1),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3moe-reduced", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=48, vocab=211, head_dim=16,
        qk_norm=True, vocab_round=8,
        moe=MoESpec(num_experts=4, top_k=2, d_ff_expert=48, period=1,
                    group_size=16),
    )
