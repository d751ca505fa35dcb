"""phi3.5-moe-42b-a6.6b — 32L d=4096 32H (GQA kv=8) d_ff=6400 vocab=32064,
MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]"""
from .base import ModelConfig, register


@register("phi3.5-moe-42b-a6.6b")
def phi35_moe() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab=32064,
        n_experts=16,
        top_k=2,
        rope_theta=10_000.0,
        skip_shapes=("long_500k",),   # pure full attention (see DESIGN §5)
    )
