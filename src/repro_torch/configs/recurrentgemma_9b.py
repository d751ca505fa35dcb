"""recurrentgemma-9b — 38L d=4096 16H (MQA kv=1) d_ff=12288 vocab=256000,
RG-LRU + local attention, 1 attention per 3 blocks.  [arXiv:2402.19427]

Hybrid: block pattern (rglru, rglru, attn) repeating; attention layers use a
bounded local window, recurrent layers carry O(1) state — so ``long_500k``
runs with a fixed-size cache.
"""
from .base import ModelConfig, register


@register("recurrentgemma-9b")
def recurrentgemma() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab=256000,
        attn_window=2048,
        lru_width=4096,
        block_pattern=("rglru", "rglru", "attn"),
        rope_theta=10_000.0,
    )
