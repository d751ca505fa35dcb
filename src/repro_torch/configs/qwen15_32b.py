"""qwen1.5-32b — 64L d=5120 40H (GQA kv=40 = MHA) d_ff=27392 vocab=152064,
QKV bias.  [hf:Qwen/Qwen1.5-* family]

MHA at 32k context is the KV-heaviest cell in the pool; the config selects
int8 KV-cache quantization so decode_32k fits the per-chip HBM budget
(see EXPERIMENTS §Dry-run).
"""
from .base import ModelConfig, register


@register("qwen1.5-32b")
def qwen15_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        kv_dtype="int8",
        skip_shapes=("long_500k",),   # pure full attention
    )
