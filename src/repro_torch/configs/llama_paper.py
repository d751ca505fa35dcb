"""Llama-family configs used by the paper's own experiments (Table 3/4).

These drive the reproduction benchmarks; they are *additional* to the ten
assigned architectures.
"""
from .base import ModelConfig, register


def _llama(name, n_layers, d_model, n_heads, kv_heads, d_ff, vocab=128256,
           **kw) -> ModelConfig:
    return ModelConfig(
        name=name, family="dense", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, kv_heads=kv_heads, head_dim=d_model // n_heads,
        d_ff=d_ff, vocab=vocab, rope_theta=500_000.0,
        skip_shapes=("long_500k",), **kw)


@register("llama3-8b")
def llama3_8b() -> ModelConfig:
    return _llama("llama3-8b", 32, 4096, 32, 8, 14336)


@register("llama3-14b")
def llama3_14b() -> ModelConfig:  # paper's interpolated 14B
    return _llama("llama3-14b", 40, 5120, 40, 8, 13824)


@register("llama1-30b")
def llama1_30b() -> ModelConfig:
    return _llama("llama1-30b", 60, 6656, 52, 52, 17920, vocab=32000)


@register("llama3-45b")
def llama3_45b() -> ModelConfig:  # paper's interpolated 45B
    return _llama("llama3-45b", 60, 6656, 52, 13, 21504)


@register("llama3-60b")
def llama3_60b() -> ModelConfig:  # paper's interpolated 60B
    return _llama("llama3-60b", 70, 7168, 56, 8, 24576)


@register("llama1-65b")
def llama1_65b() -> ModelConfig:
    return _llama("llama1-65b", 80, 8192, 64, 64, 22016, vocab=32000)


@register("llama3-70b")
def llama3_70b() -> ModelConfig:
    return _llama("llama3-70b", 80, 8192, 64, 8, 28672)
