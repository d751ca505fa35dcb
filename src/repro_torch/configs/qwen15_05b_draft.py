"""qwen1.5-0.5b — 24L d=1024 16H (MHA) d_ff=2816, tied embeddings, QKV
bias.  [hf:Qwen/Qwen1.5-0.5B]

The draft model for the paper's 32B speculative-decoding scenario: same
tokenizer family as qwen1.5-32b (vocab kept identical to the target
config so draft tokens index the target's logits directly), ~60x fewer
parameters, so a draft step costs ~1-2% of a target step on the home
cluster while the target verifies the whole draft block in one
weight-streaming pass.
"""
from .base import ModelConfig, register


@register("qwen1.5-0.5b")
def qwen15_05b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab=152064,              # must match the spec-decode target
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        skip_shapes=("long_500k",),
    )
