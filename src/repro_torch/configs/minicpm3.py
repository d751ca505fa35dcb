"""minicpm3-4b — 62L d=2560 40H d_ff=6400 vocab=73448, MLA (multi-head
latent attention).  [hf:openbmb/MiniCPM3-4B]

MLA caches a compressed latent (kv_lora_rank + rope dims per token) instead
of per-head K/V — the KV term in the Halda latency model shrinks from
2*h*e to (r + rope) accordingly (DESIGN §5).
"""
from .base import ModelConfig, register


@register("minicpm3-4b")
def minicpm3() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        kv_heads=40,                 # MLA: effective heads; cache is latent
        head_dim=64,
        d_ff=6400,
        vocab=73448,
        mla=True,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
        rope_theta=10_000.0,
        skip_shapes=("long_500k",),   # full attention (latent cache, but
                                      # quadratic scores)
    )
