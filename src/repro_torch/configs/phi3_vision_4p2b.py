"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stub).

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064. The vision frontend is
a STUB per spec: input_specs() provides precomputed patch embeddings
(B, P, d_model) fused early with the token embeddings.
[hf:microsoft/Phi-3-vision-128k-instruct]
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm", num_layers=32, d_model=3072,
        num_heads=32, num_kv_heads=32, d_ff=8192, vocab=32064,
        vision_patches=256,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3v-reduced", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab=211,
        vision_patches=8, vocab_round=8,
    )
