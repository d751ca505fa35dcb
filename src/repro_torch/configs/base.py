"""Architecture configuration system (a copy of ``repro.configs.base``).

Every assigned architecture is a ``ModelConfig`` instance registered under
its public id; ``--arch <id>`` everywhere resolves through ``get_config``.
Configs carry exact published hyperparameters plus the bookkeeping the
framework needs: parameter accounting (for the profiler / roofline),
input specs per benchmark shape (for the dry-run), and a ``reduced()``
variant for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

GiB = float(1 << 30)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One benchmark cell: (seq_len, global_batch, kind)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: The assigned input-shape set (identical across LM-family archs).
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    # --- MoE ------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    #: expert capacity factor for train/prefill dispatch; ``None`` = lossless
    #: (capacity = T, no token ever dropped). Decode is always lossless.
    moe_capacity_factor: Optional[float] = 1.25
    # --- attention variants ----------------------------------------------
    attn_window: Optional[int] = None     # sliding-window attention
    mla: bool = False                      # multi-head latent attention
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- recurrent / SSM ---------------------------------------------------
    ssm_state: int = 0             # Mamba-2 state dimension N
    d_inner: int = 0               # Mamba-2 expanded width
    ssm_head_dim: int = 64         # Mamba-2 P (head dim)
    conv_width: int = 4
    lru_width: int = 0             # RG-LRU recurrence width
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn")
    # --- modality frontend (stub per spec) --------------------------------
    frontend: Optional[str] = None        # "vision" | "audio"
    n_frontend_tokens: int = 0            # precomputed embedding count
    mrope: bool = False                   # multimodal rotary (Qwen2-VL)
    # --- encoder-decoder ---------------------------------------------------
    n_enc_layers: int = 0                 # whisper encoder depth
    max_decode_len: int = 0               # architecture-bound decoder context
    # --- numerics -----------------------------------------------------------
    kv_dtype: str = "bfloat16"            # "bfloat16" | "int8"
    use_rope: bool = True                 # whisper: absolute sinusoidal only
    # Which benchmark shapes apply to this arch. ``long_500k`` is only for
    # sub-quadratic archs; others note the skip.
    skip_shapes: Tuple[str, ...] = ()

    # ------------------------------------------------------------------ #
    #  derived dimensions
    # ------------------------------------------------------------------ #

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def q_dim(self) -> int:
        if self.mla:
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        if self.mla:
            return self.kv_lora_rank + self.qk_rope_dim  # latent cache width
        return self.kv_heads * self.head_dim

    def layer_kind(self, layer: int) -> str:
        """Mixer kind for layer ``layer`` (hybrid archs interleave)."""
        if self.family == "ssm":
            return "ssm"
        if self.block_pattern:
            return self.block_pattern[layer % len(self.block_pattern)]
        return "attn"

    def layer_kinds(self) -> List[str]:
        return [self.layer_kind(i) for i in range(self.n_layers)]

    # ------------------------------------------------------------------ #
    #  parameter accounting (used by profiler + roofline MODEL_FLOPS)
    # ------------------------------------------------------------------ #

    def attn_params(self) -> int:
        d = self.d_model
        if self.mla:
            # q: d->q_lora->heads*(nope+rope); kv: d->kv_lora(+rope);
            # up: kv_lora->heads*(nope+v); o: heads*v->d
            p = d * self.q_lora_rank
            p += self.q_lora_rank * self.n_heads * (self.qk_nope_dim
                                                    + self.qk_rope_dim)
            p += d * (self.kv_lora_rank + self.qk_rope_dim)
            p += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim
                                                     + self.v_head_dim)
            p += self.n_heads * self.v_head_dim * d
            return p
        q = d * self.n_heads * self.head_dim
        kv = 2 * d * self.kv_heads * self.head_dim
        o = self.n_heads * self.head_dim * d
        bias = (self.n_heads + 2 * self.kv_heads) * self.head_dim \
            if self.qkv_bias else 0
        return q + kv + o + bias

    def ffn_params_per_expert(self) -> int:
        # gated GLU: gate + up + down
        return 3 * self.d_model * self.d_ff

    def mixer_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "attn":
            return self.attn_params()
        if kind == "rglru":
            # Griffin recurrent block: in-proj x2 (d->lru), conv(4), RG-LRU
            # gates (2 per-channel + 2 input proj), out-proj
            w = self.lru_width or d
            return 2 * d * w + 4 * w + 2 * w + 2 * w * w // max(w // d, 1) \
                if False else (2 * d * w + 4 * w + 4 * w + w * d)
        if kind == "ssm":
            # Mamba-2: in_proj d -> (2*d_inner + 2*groups*state + heads),
            # conv, dt/A/D, out_proj d_inner -> d
            di, N = self.d_inner, self.ssm_state
            nh = di // self.ssm_head_dim
            p = self.d_model * (2 * di + 2 * N + nh)
            p += self.conv_width * (di + 2 * N)
            p += 2 * nh                      # A_log, D
            p += di * self.d_model
            p += di                          # norm gate
            return p
        raise ValueError(kind)

    def params_per_layer(self) -> int:
        """Mean parameters per layer (weights only, no embeddings)."""
        total = 0
        for kind in self.layer_kinds():
            total += self.mixer_params(kind)
            if kind in ("attn", "rglru"):
                if self.n_experts:
                    total += self.n_experts * self.ffn_params_per_expert()
                    total += self.d_model * self.n_experts  # router
                else:
                    total += self.ffn_params_per_expert()
            elif kind == "ssm":
                pass  # Mamba-2 block has no separate FFN
            total += 2 * self.d_model  # 2 RMSNorm scales
        return total // self.n_layers

    def active_params_per_layer(self) -> int:
        """Per-token active parameters (MoE: only top_k experts)."""
        if not self.n_experts:
            return self.params_per_layer()
        total = 0
        for kind in self.layer_kinds():
            total += self.mixer_params(kind)
            total += self.top_k * self.ffn_params_per_expert()
            total += self.d_model * self.n_experts
            total += 2 * self.d_model
        return total // self.n_layers

    def embedding_params(self) -> int:
        p = self.vocab * self.d_model
        if not self.tie_embeddings:
            p *= 2
        return p

    def total_params(self) -> int:
        p = self.n_layers * self.params_per_layer() + self.embedding_params()
        if self.n_enc_layers:
            # encoder layers: attn + ffn (no cross-attn in encoder);
            # decoder layers counted above also carry cross-attention.
            enc = self.n_enc_layers * (self.attn_params()
                                       + self.ffn_params_per_expert()
                                       + 2 * self.d_model)
            dec_cross = self.n_layers * self.attn_params()
            p += enc + dec_cross
        return p

    def total_active_params(self) -> int:
        return (self.n_layers * self.active_params_per_layer()
                + self.embedding_params())

    # ------------------------------------------------------------------ #
    #  smoke-test reduction
    # ------------------------------------------------------------------ #

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: Dict = {}
        kw["n_layers"] = min(self.n_layers, 4 if not self.block_pattern
                             else 2 * len(self.block_pattern))
        kw["d_model"] = 64
        kw["n_heads"] = 4 if self.n_heads else 0
        kw["kv_heads"] = (min(self.kv_heads, 4) if self.kv_heads else 0)
        if self.kv_heads == self.n_heads:
            kw["kv_heads"] = 4
        elif self.kv_heads:
            kw["kv_heads"] = max(1, 4 * self.kv_heads // self.n_heads)
        kw["head_dim"] = 16
        kw["d_ff"] = 128
        kw["vocab"] = 256
        if self.n_experts:
            kw["n_experts"] = 4
            kw["top_k"] = min(self.top_k, 2)
            kw["moe_capacity_factor"] = None   # exactness for smoke tests
        if self.attn_window:
            kw["attn_window"] = 32
        if self.mla:
            kw["q_lora_rank"] = 32
            kw["kv_lora_rank"] = 16
            kw["qk_nope_dim"] = 8
            kw["qk_rope_dim"] = 8
            kw["v_head_dim"] = 8
        if self.ssm_state:
            kw["ssm_state"] = 16
            kw["d_inner"] = 128
            kw["ssm_head_dim"] = 16
        if self.lru_width:
            kw["lru_width"] = 64
        if self.n_frontend_tokens:
            kw["n_frontend_tokens"] = 16
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
        if self.max_decode_len:
            kw["max_decode_len"] = 64
        kw["name"] = self.name + "-smoke"
        return dataclasses.replace(self, **kw)

    def shapes(self) -> List[ShapeSpec]:
        return [s for k, s in SHAPES.items() if k not in self.skip_shapes]


# --------------------------------------------------------------------------- #
#  registry
# --------------------------------------------------------------------------- #

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    from . import ALL_ARCHS  # noqa: F401  (triggers module imports)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> List[str]:
    from . import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)
