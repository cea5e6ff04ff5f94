"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.

64L d_model=2560 (d_ff=0: the Mamba-2 block contains its own gated MLP
capacity via expand=2), vocab 50280 (padded to 50432), ssm_state=128.
[arXiv:2405.21060]
"""
from .base import ModelConfig, SSMSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", num_layers=64, d_model=2560,
        num_heads=80, num_kv_heads=80, d_ff=0, vocab=50280,
        ssm=SSMSpec(d_state=128, headdim=64, expand=2, ngroups=1,
                    d_conv=4, chunk=256),
        block_pattern=("M",), sub_quadratic=True, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-reduced", family="ssm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab=503,
        ssm=SSMSpec(d_state=16, headdim=16, expand=2, ngroups=1,
                    d_conv=4, chunk=8),
        block_pattern=("M",), sub_quadratic=True, tie_embeddings=True,
        vocab_round=8,
    )
