"""llama4-maverick-400b-a17b [moe] — interleaved MoE + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 128 experts top-1.
Maverick interleaves MoE every other layer (dense d_ff elsewhere) and runs a
shared expert in parallel with the routed one. [hf:meta-llama/Llama-4-*]
"""
from .base import ModelConfig, MoESpec


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe", num_layers=48,
        d_model=5120, num_heads=40, num_kv_heads=8, d_ff=8192, vocab=202048,
        rope_theta=5e5,
        moe=MoESpec(num_experts=128, top_k=1, d_ff_expert=8192, period=2,
                    shared_expert=True),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-reduced", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab=307, vocab_round=8,
        moe=MoESpec(num_experts=4, top_k=1, d_ff_expert=128, period=2,
                    shared_expert=True, group_size=16),
    )
