"""mixtral-8x7b — 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention (4096).  [arXiv:2401.04088]"""
from .base import ModelConfig, register


@register("mixtral-8x7b")
def mixtral() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=32000,
        n_experts=8,
        top_k=2,
        attn_window=4096,            # SWA: rolling KV buffer
        rope_theta=1_000_000.0,
        # SWA bounds the KV cache -> long_500k runs (rolling 4096 window)
    )
