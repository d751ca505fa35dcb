"""mamba2-780m — 48L d=1536, attention-free, vocab=50280, SSD state=128.
[arXiv:2405.21060]

State-space duality (SSD): per-layer state is (heads, head_dim, state) —
O(1) in sequence length, so every decode shape including ``long_500k`` runs
with constant memory.
"""
from .base import ModelConfig, register


@register("mamba2-780m")
def mamba2() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab=50280,
        ssm_state=128,
        d_inner=3072,               # expand = 2
        ssm_head_dim=64,            # -> 48 SSD heads
        conv_width=4,
        tie_embeddings=True,
    )
