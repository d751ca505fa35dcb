"""qwen2-vl-2b — 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, M-RoPE.
[arXiv:2409.12191]

Backbone only per the assignment: the vision frontend is a STUB —
``input_specs`` provides precomputed patch embeddings (B, n_patches, d)
which the model prepends to the token embeddings; M-RoPE applies 3-D
(temporal, height, width) rotary sections to the patch positions.
"""
from .base import ModelConfig, register


@register("qwen2-vl-2b")
def qwen2_vl() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab=151936,
        qkv_bias=True,
        mrope=True,
        frontend="vision",
        n_frontend_tokens=256,       # precomputed patch embeddings per image
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        skip_shapes=("long_500k",),   # pure full attention
    )
