"""qwen2.5-14b — 48L d=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias.
[hf:Qwen/Qwen2.5-* family]"""
from .base import ModelConfig, register


@register("qwen2.5-14b")
def qwen25_14b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        skip_shapes=("long_500k",),   # pure full attention
    )
