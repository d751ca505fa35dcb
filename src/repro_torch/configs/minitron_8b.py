"""minitron-8b — 32L d=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Pruned Nemotron.  [arXiv:2407.14679]"""
from .base import ModelConfig, register


@register("minitron-8b")
def minitron() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=256000,
        rope_theta=10_000.0,
        skip_shapes=("long_500k",),   # pure full attention
    )
