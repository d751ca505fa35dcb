"""whisper-tiny — 4L enc + 4L dec, d=384 6H (kv=6) d_ff=1536 vocab=51865,
encoder-decoder with conv frontend (stub).  [arXiv:2212.04356]

The conv/mel frontend is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings (B, 1500, d). The decoder has a
448-token context by construction; the 32k decode shapes are lowered for
shape coverage only (DESIGN §5).
"""
from .base import ModelConfig, register


@register("whisper-tiny")
def whisper_tiny() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,                 # decoder depth
        n_enc_layers=4,
        d_model=384,
        n_heads=6,
        kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab=51865,
        frontend="audio",
        n_frontend_tokens=1500,     # precomputed mel-frame embeddings
        max_decode_len=448,
        tie_embeddings=True,
        use_rope=False,              # absolute sinusoidal positions
        skip_shapes=("long_500k",),   # 448-token decoder context
    )
