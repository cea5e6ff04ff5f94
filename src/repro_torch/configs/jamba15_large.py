"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer. 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536. [arXiv:2403.19887]

Layer pattern (period 8, tiled 9x = 72 layers): attention at position 4,
Mamba elsewhere; MoE replaces the dense FF on every other layer. Each layer
is (mixer, FF) like the Jamba paper. Our SSD block stands in for Jamba's
Mamba-1 mixer (same state size; DESIGN.md §6).
"""
from .base import ModelConfig, MoESpec, SSMSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid", num_layers=72,
        d_model=8192, num_heads=64, num_kv_heads=8, d_ff=24576, vocab=65536,
        block_pattern=("M", "M", "M", "M", "A", "M", "M", "M"),
        moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=24576, period=2),
        ssm=SSMSpec(d_state=128, headdim=128, expand=2, ngroups=8,
                    d_conv=4, chunk=256),
        sub_quadratic=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-reduced", family="hybrid", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab=211, vocab_round=8,
        block_pattern=("M", "A"),
        moe=MoESpec(num_experts=4, top_k=2, d_ff_expert=128, period=2,
                    group_size=16),
        ssm=SSMSpec(d_state=16, headdim=16, expand=2, ngroups=2,
                    d_conv=4, chunk=8),
        sub_quadratic=True,
    )
