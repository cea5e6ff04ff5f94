"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.

24L enc + 24L dec, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 (padded
256256). The speech frontend is a STUB per spec: input_specs() provides
precomputed frame embeddings (B, S, d_model) to the encoder.
[arXiv:2308.11596]
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec", num_layers=24,
        enc_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab=256206, audio_frontend=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-reduced", family="encdec", num_layers=2, enc_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab=333,
        vocab_round=8, audio_frontend=True,
    )
