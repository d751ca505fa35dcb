"""Model assembly of the port: every family of ``repro.models.model``
(dense GQA, MLA, moe, vlm, ssm, hybrid, audio), init / forward / prefill /
decode over a dense cache (the attention families also over a paged KV
cache), with resident weights or layer by layer from a ``ParamSource``
(the streamed path).

Parameters are ``nn.Module``s whose tensors keep the JAX pytree's names
and (in, out) layouts: ``DenseModel`` holds ``blocks`` in execution
order, each a ``DenseBlock`` (``Attention`` or ``MLA``, then ``GLU`` or
``MoE``), an ``SSDBlock`` or (hybrid) an ``RGLRUBlock``; whisper's
``WhisperModel`` adds the encoder (``enc_blocks``, ``enc_norm``) and its
``blocks`` are ``DecBlock``s. A Python loop over ``blocks`` takes the
place of ``lax.scan``. The hybrid family's flat block list runs the JAX
layout's groups in order (group g's blocks b0, b1, ... of
``cfg.block_pattern``), then its tail. A moe block's dispatch drops rows
over capacity where the JAX package's does: in a dense or layer-wise
prefill (``moe_capacity_factor``; None, as the reduced configs set it,
drops nothing); decode, the paged paths and the ring run lossless.

Caches (device tensors, written in place):

  dense  : {"len": (B,), "layers": {"k"/"v": (L, B, S_max, h_kv, hd)
            [+ "k_scale"/"v_scale": (L, B, S_max, h_kv)]}}
            (S_max = min(max_len, window) for a windowed model: a rolling
            buffer)
  MLA    : {"len", "layers": {"latent": (L, B, S_max, r_kv + rope dims)}}
  ssm    : {"len", "layers": {"conv": (L, B, K-1, di+2N),
            "state": (L, B, nh, P, N)}}
  hybrid : {"len", "groups": {"b<i>": the leaves of block kind i, leading
            axis G}, "tail": leading axis n_tail}; an RG-LRU's leaves are
            {"h": (B, w), "conv": (B, K-1, w)}, an attention layer's the
            dense ones
  audio  : {"len", "layers": {"k"/"v": (L, B, min(max_len,
            max_decode_len), ...)}, "cross_k"/"cross_v": (L, B, F, h_kv,
            hd)}
  paged  : {"pages": {leaf: (L, P, bs, ...)}, "block_table": (B, nb),
            "len": (B,)}  (built by ``runtime.kvcache.PagedKVCache``;
            dense GQA, MLA, moe and vlm)

Every function returns a new cache dict (``len`` advanced) over the same
tensors, so callers keep the JAX package's ``cache = f(cache, ...)`` flow
(``rollback_cache`` resets ``len`` in place, and the graphed steps of
``runtime`` write the advanced ``len`` into the cache's own tensor).
An ssm prefill into a cache no token has entered yet (``len`` 0
everywhere: ``init_cache``'s zero state) runs the SSD scan through kernel
B6 on the card; recurrent state (ssm, hybrid) cannot roll back, so decode
takes one token a sequence (T = 1), as in the JAX package, and so does
whisper's decoder. A vlm model takes positions (3, B, S) for its M-RoPE
(``default_positions`` broadcasts one stream to the three) and
``embeds`` (patch embeddings) prepended to the tokens'; whisper takes
its encoder's frames as ``embeds``.

The layer-wise paths (``forward_layerwise``, ``prefill_layerwise``,
``decode_step_layerwise``) pull each layer's tree from
``source.layer(i)`` (``runtime.paramstore`` / ``runtime.streaming``;
dense, MLA, moe, vlm and ssm). A q4 ``QuantizedTensor`` under a
projection key stays packed and goes through ``layers.qmm`` (kernel B3 on
the card), a q4 expert stack through ``layers.expert_mm`` (B3 once an
expert); any other quantized leaf (MLA's einsum-consumed projections
included) is dequantized to f32 when its layer is pulled.
"""
from __future__ import annotations

import math
import types
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..quant.grouped import QuantizedTensor, dequantize_leaf, dequantize_tree
from ..runtime.paramstore import STACKED_FAMILIES
from . import layers as ll


def _param(t):
    """A frozen parameter (``runtime.train.make_trainable`` thaws a
    model's float leaves); a packed ``QuantizedTensor`` stays a plain
    attribute (``layers.qmm`` consumes it)."""
    if isinstance(t, QuantizedTensor):
        return t
    return nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))
        if bq is not None:
            self.bq, self.bk, self.bv = map(_param, (bq, bk, bv))


#: MLA's leaves, in the JAX tree's order
MLA_KEYS = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b",
            "wo")


class MLA(nn.Module):
    """Multi-head latent attention: wq_a (d, r_q), q_norm (r_q,), wq_b
    (r_q, H (dn + dr)), wkv_a (d, r_kv + dr), kv_norm (r_kv,), wk_b (r_kv,
    H dn), wv_b (r_kv, H dv), wo (H dv, d)."""

    def __init__(self, *leaves):
        super().__init__()
        for name, t in zip(MLA_KEYS, leaves):
            setattr(self, name, _param(t))


class GLU(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(_param,
                                                  (w_gate, w_up, w_down))


class MoE(nn.Module):
    """router (d, E), w_gate/w_up (E, d, f), w_down (E, f, d)."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = map(
            _param, (router, w_gate, w_up, w_down))


#: an MoE's leaves, in the JAX tree's order
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


class DenseBlock(nn.Module):
    """Attention (``Attention`` or ``MLA``) and an FFN: ``GLU`` (held as
    ``ffn``) or ``MoE`` (held as ``moe``, the JAX tree's key)."""

    def __init__(self, attn_norm, attn, ffn_norm, ffn):
        super().__init__()
        self.attn_norm = _param(attn_norm)
        self.attn = attn
        self.ffn_norm = _param(ffn_norm)
        if isinstance(ffn, MoE):
            self.moe = ffn
        else:
            self.ffn = ffn


#: the SSD mixer's leaves, in the JAX tree's order
SSD_KEYS = ("in_proj", "conv_w", "dt_bias", "a_log", "d_skip", "norm",
            "out_proj")


class SSD(nn.Module):
    """The Mamba-2 mixer: in_proj (d, 2di+2N+nh), conv_w (K, di+2N),
    dt_bias/a_log/d_skip (nh,), norm (di,), out_proj (di, d)."""

    def __init__(self, in_proj, conv_w, dt_bias, a_log, d_skip, norm,
                 out_proj):
        super().__init__()
        for name, t in zip(SSD_KEYS, (in_proj, conv_w, dt_bias, a_log,
                                      d_skip, norm, out_proj)):
            setattr(self, name, _param(t))


class SSDBlock(nn.Module):
    def __init__(self, norm, ssd: SSD):
        super().__init__()
        self.norm = _param(norm)
        self.ssd = ssd


#: the RG-LRU's leaves, in the JAX tree's order
RGLRU_KEYS = ("w_x", "w_y", "conv_w", "gate_i", "gate_r", "lambda", "w_out")


class RGLRU(nn.Module):
    """The RG-LRU mixer: w_x/w_y (d, w), conv_w (K, w), gate_i/gate_r/
    lambda (w,), w_out (w, d) (``lambda`` is read with ``getattr``)."""

    def __init__(self, *leaves):
        super().__init__()
        for name, t in zip(RGLRU_KEYS, leaves):
            setattr(self, name, _param(t))


class RGLRUBlock(nn.Module):
    """The hybrid family's recurrent block: mixer and GLU."""

    def __init__(self, mix_norm, rglru: RGLRU, ffn_norm, ffn: GLU):
        super().__init__()
        self.mix_norm = _param(mix_norm)
        self.rglru = rglru
        self.ffn_norm = _param(ffn_norm)
        self.ffn = ffn


class DecBlock(nn.Module):
    """Whisper's decoder block: self attention, cross attention over the
    encoder's output, GLU."""

    def __init__(self, attn_norm, cross_norm, ffn_norm, attn: Attention,
                 cross: Attention, ffn: GLU):
        super().__init__()
        self.attn_norm = _param(attn_norm)
        self.cross_norm = _param(cross_norm)
        self.ffn_norm = _param(ffn_norm)
        self.attn, self.cross, self.ffn = attn, cross, ffn


class DenseModel(nn.Module):
    """Embedding, a stack of blocks in execution order, final norm and
    (untied) unembedding. ``groups``: a hybrid model's (G, pattern length),
    the layout of the JAX tree its blocks came from."""

    def __init__(self, embed, final_norm, blocks, unembed=None, *,
                 groups: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = _param(final_norm)
        self.blocks = nn.ModuleList(blocks)
        if unembed is not None:
            self.unembed = _param(unembed)
        self.groups = groups


class WhisperModel(DenseModel):
    """Whisper: ``blocks`` is the decoder (``DecBlock``s); the encoder is
    ``enc_blocks`` (``DenseBlock``s) and ``enc_norm``."""

    def __init__(self, embed, final_norm, blocks, enc_blocks, enc_norm,
                 unembed=None):
        super().__init__(embed, final_norm, blocks, unembed)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_norm = _param(enc_norm)


# --------------------------------------------------------------------------- #
#  init
# --------------------------------------------------------------------------- #

def _draws(generator: torch.Generator, dtype, device):
    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return t.mul_(scale)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)
    return normal, ones, zeros


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, n_tail) for hybrid block_pattern archs."""
    g = len(cfg.block_pattern)
    return cfg.n_layers // g, cfg.n_layers % g


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's kind in execution order: "attn" (a ``DenseBlock``),
    "ssd" or "rglru"; a hybrid model's groups of ``cfg.block_pattern``,
    then its tail (the pattern's first kind)."""
    if cfg.family == "ssm":
        return ["ssd"] * cfg.n_layers
    if cfg.family == "hybrid":
        G, T = hybrid_layout(cfg)
        return list(cfg.block_pattern) * G + [cfg.block_pattern[0]] * T
    return ["attn"] * cfg.n_layers


def _init_ssd_block(cfg: ModelConfig, normal, ones, zeros, dtype,
                    device) -> SSDBlock:
    d, di, N, P = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // P
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                     device=device)).to(dtype)
    ssd = SSD(normal((d, 2 * di + 2 * N + nh), 1.0 / math.sqrt(d)),
              normal((cfg.conv_width, di + 2 * N), 0.1), zeros(nh), a_log,
              ones(nh), ones(di), normal((di, d), 1.0 / math.sqrt(di)))
    return SSDBlock(ones(d), ssd)


def _init_attn(cfg: ModelConfig, normal, ones, zeros):
    d, H, hk, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    if cfg.mla:
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return MLA(normal((d, r_q), s), ones(r_q),
                   normal((r_q, H * (dn + dr)), 1.0 / math.sqrt(r_q)),
                   normal((d, r_kv + dr), s), ones(r_kv),
                   normal((r_kv, H * dn), 1.0 / math.sqrt(r_kv)),
                   normal((r_kv, H * dv), 1.0 / math.sqrt(r_kv)),
                   normal((H * dv, d), 1.0 / math.sqrt(H * dv)))
    bias = (zeros(H * hd), zeros(hk * hd), zeros(hk * hd)) \
        if cfg.qkv_bias else ()
    return Attention(normal((d, H * hd), s), normal((d, hk * hd), s),
                     normal((d, hk * hd), s), normal((H * hd, d), s), *bias)


def _init_glu(cfg: ModelConfig, normal) -> GLU:
    d, f = cfg.d_model, cfg.d_ff
    return GLU(normal((d, f), 1.0 / math.sqrt(d)),
               normal((d, f), 1.0 / math.sqrt(d)),
               normal((f, d), 1.0 / math.sqrt(f)))


def _init_rglru_block(cfg: ModelConfig, normal, ones, zeros, dtype,
                      device) -> RGLRUBlock:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    lam = torch.log(torch.expm1(torch.linspace(4.0, 9.0, w,
                                               dtype=torch.float32,
                                               device=device))).to(dtype)
    rglru = RGLRU(normal((d, w), 1.0 / math.sqrt(d)),
                  normal((d, w), 1.0 / math.sqrt(d)),
                  normal((cfg.conv_width, w), 0.1), zeros(w), zeros(w), lam,
                  normal((w, d), 1.0 / math.sqrt(w)))
    return RGLRUBlock(ones(d), rglru, ones(d), _init_glu(cfg, normal))


def init_block(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32, device="cuda",
               kind: Optional[str] = None):
    """One block's random weights, drawn from ``generator``, with the JAX
    init's distributions: a ``DenseBlock`` (``kind`` "attn": normal scaled
    by 1/sqrt(fan-in), zero biases, unit norms; attention or MLA, then the
    GLU or the MoE's router, w_gate, w_up and w_down), an SSD block
    ("ssd": projections as dense, conv_w normal x 0.1, dt_bias 0, a_log
    log(linspace(1, 16, nh)), d_skip 1, unit norms), an RG-LRU block
    ("rglru": conv_w normal x 0.1, zero gates, lambda softplus^-1 of
    linspace(4, 9, w)), or whisper's decoder block ("dec"). None: the
    family's own ("ssd" for ssm, else "attn")."""
    if kind is None:
        kind = "ssd" if cfg.family == "ssm" else "attn"
    normal, ones, zeros = _draws(generator, dtype, device)
    if kind == "ssd":
        return _init_ssd_block(cfg, normal, ones, zeros, dtype, device)
    if kind == "rglru":
        return _init_rglru_block(cfg, normal, ones, zeros, dtype, device)
    if kind == "dec":
        attn = _init_attn(cfg, normal, ones, zeros)
        cross = _init_attn(cfg, normal, ones, zeros)
        return DecBlock(ones(cfg.d_model), ones(cfg.d_model),
                        ones(cfg.d_model), attn, cross,
                        _init_glu(cfg, normal))
    d, f = cfg.d_model, cfg.d_ff
    attn = _init_attn(cfg, normal, ones, zeros)
    if cfg.n_experts:
        E, s = cfg.n_experts, 1.0 / math.sqrt(d)
        ffn = MoE(normal((d, E), s), normal((E, d, f), s),
                  normal((E, d, f), s), normal((E, f, d), 1.0 / math.sqrt(f)))
    else:
        ffn = _init_glu(cfg, normal)
    return DenseBlock(ones(d), attn, ones(d), ffn)


def init_head(cfg: ModelConfig, generator: torch.Generator,
              dtype=torch.float32, device="cuda") -> Dict[str, torch.Tensor]:
    """The non-block weights: {"embed" (x0.02), "final_norm" (ones)[,
    "unembed" (1/sqrt(d)) unless tied]}."""
    normal, ones, _ = _draws(generator, dtype, device)
    head = {}
    if not cfg.tie_embeddings:
        head["unembed"] = normal((cfg.d_model, cfg.vocab),
                                 1.0 / math.sqrt(cfg.d_model))
    head["embed"] = normal((cfg.vocab, cfg.d_model), 0.02)
    head["final_norm"] = ones(cfg.d_model)
    return head


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> DenseModel:
    """Random weights with the JAX package's distributions (``init_block``,
    embed x0.02), drawn from ``generator`` (which must live on
    ``device``): the blocks in execution order (whisper: the encoder's,
    then the decoder's), then the head."""
    if cfg.family == "audio":
        enc = [init_block(cfg, generator, dtype, device)
               for _ in range(cfg.n_enc_layers)]
        dec = [init_block(cfg, generator, dtype, device, kind="dec")
               for _ in range(cfg.n_layers)]
        head = init_head(cfg, generator, dtype, device)
        return WhisperModel(head["embed"], head["final_norm"], dec, enc,
                            torch.ones(cfg.d_model, dtype=dtype,
                                       device=device), head.get("unembed"))
    blocks = [init_block(cfg, generator, dtype, device, kind=kind)
              for kind in layer_kinds(cfg)]
    head = init_head(cfg, generator, dtype, device)
    groups = (hybrid_layout(cfg)[0], len(cfg.block_pattern)) \
        if cfg.family == "hybrid" else None
    return DenseModel(head["embed"], head["final_norm"], blocks,
                      head.get("unembed"), groups=groups)


def _kv_cache(cfg: ModelConfig, n: int, batch: int, S: int, dtype,
              device) -> Dict[str, torch.Tensor]:
    """n layers of K/V lines (a rolling buffer of min(S, window) lines for
    a windowed model), int8 with bf16 scales for ``kv_dtype`` int8."""
    hk, hd = max(cfg.kv_heads, 1), cfg.head_dim
    if cfg.attn_window:
        S = min(S, cfg.attn_window)
    shape = (n, batch, S, hk, hd)
    if cfg.kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _rglru_cache(cfg: ModelConfig, n: int, batch: int, dtype, device):
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((n, batch, w), dtype=dtype, device=device),
            "conv": torch.zeros((n, batch, cfg.conv_width - 1, w),
                                dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda") -> Dict:
    """The family's dense cache (see the module docstring): K/V lines
    (int8 + bf16 scales when ``cfg.kv_dtype == "int8"``), MLA's latent
    lines, the ssm family's conv window and recurrent state, the hybrid
    family's tree of groups and tail, or whisper's self-attention lines
    (at most ``max_decode_len``) and cross K/V. Zero; ``len`` 0."""
    L = cfg.n_layers
    cache: Dict = {"len": torch.zeros((batch,), dtype=torch.int32,
                                      device=device)}
    if cfg.family == "ssm":
        di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
        cache["layers"] = {
            "conv": torch.zeros((L, batch, cfg.conv_width - 1, di + 2 * N),
                                dtype=dtype, device=device),
            "state": torch.zeros((L, batch, di // P, P, N), dtype=dtype,
                                 device=device)}
    elif cfg.family == "hybrid":
        G, T = hybrid_layout(cfg)
        cache["groups"] = {
            f"b{i}": _rglru_cache(cfg, G, batch, dtype, device)
            if kind == "rglru"
            else _kv_cache(cfg, G, batch, max_len, dtype, device)
            for i, kind in enumerate(cfg.block_pattern)}
        if T:
            cache["tail"] = _rglru_cache(cfg, T, batch, dtype, device) \
                if cfg.block_pattern[0] == "rglru" \
                else _kv_cache(cfg, T, batch, max_len, dtype, device)
    elif cfg.family == "audio":
        S = min(max_len, cfg.max_decode_len or max_len)
        cache["layers"] = _kv_cache(cfg, L, batch, S, dtype, device)
        shape = (L, batch, cfg.n_frontend_tokens, cfg.kv_heads, cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    elif cfg.mla:
        cache["layers"] = {"latent": torch.zeros(
            (L, batch, max_len, cfg.kv_lora_rank + cfg.qk_rope_dim),
            dtype=dtype, device=device)}
    else:
        cache["layers"] = _kv_cache(cfg, L, batch, max_len, dtype, device)
    return cache


# --------------------------------------------------------------------------- #
#  embeddings / positions
# --------------------------------------------------------------------------- #

def embed_tokens(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params.embed[tokens.long()]


def unembed(params: DenseModel, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    if hasattr(params, "unembed"):
        return ll._matmul(x, params.unembed)
    return ll._matmul(x, params.embed.T)


def default_positions(cfg: ModelConfig, B: int, S: int, offset=0
                      ) -> torch.Tensor:
    """(B, S) positions from ``offset`` (an int, or (B,) lengths); an
    M-RoPE model's one stream broadcast to its three, (3, B, S)."""
    dev = offset.device if isinstance(offset, torch.Tensor) else None
    base = torch.arange(S, dtype=torch.int32, device=dev)[None]
    if isinstance(offset, torch.Tensor):
        pos = offset.to(torch.int32)[:, None] + base
    else:
        pos = (base + offset).expand(B, S)
    if cfg.mrope:
        return pos[None].expand(3, B, S)
    return pos


def sinusoid_positions(S: int, d: int, dtype, device) -> torch.Tensor:
    """Whisper's absolute positions: (S, d), sines then cosines."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _embed_input(params, cfg: ModelConfig, tokens: torch.Tensor,
                 embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings, with ``embeds`` (a frontend's, e.g. patch
    embeddings) prepended."""
    x = embed_tokens(params, cfg, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], 1)
    return x


# --------------------------------------------------------------------------- #
#  block application
# --------------------------------------------------------------------------- #

def _layer_cache(cfg: ModelConfig, cache: Optional[Dict], i: int
                 ) -> Optional[Dict]:
    """Layer ``i``'s views of a dense cache (written in place); a hybrid
    model's layer ``i`` is row i // P of group leaf ``b{i % P}``, or a row
    of the tail."""
    if cache is None:
        return None
    tree, j = cache.get("layers"), i
    if cfg.family == "hybrid":
        G, _ = hybrid_layout(cfg)
        P = len(cfg.block_pattern)
        tree, j = (cache["groups"][f"b{i % P}"], i // P) if i < G * P \
            else (cache["tail"], i - G * P)
    c = {name: arr[j] for name, arr in tree.items()}
    c["len"] = cache["len"]
    return c


def _advance(cache: Optional[Dict], n: int) -> Optional[Dict]:
    return None if cache is None else {**cache, "len": cache["len"] + n}


def _attn(p, cfg: ModelConfig, h, positions, c: Optional[Dict], *,
          decode: bool):
    if cfg.mla:
        return ll.mla_block(p, cfg, h, positions, cache=c, decode=decode)[0]
    return ll.attn_block(p, cfg, h, positions, cache=c, decode=decode)[0]


def _dense_layer(p, cfg: ModelConfig, x, positions, c: Optional[Dict], *,
                 decode: bool):
    x = x + _attn(p.attn, cfg, ll.rms_norm(x, p.attn_norm, cfg.norm_eps),
                  positions, c, decode=decode)
    return x + ll.block_ffn(p, cfg, ll.rms_norm(x, p.ffn_norm, cfg.norm_eps),
                            lossless=decode)


def _ssd_layer(p, cfg: ModelConfig, x, c: Optional[Dict], *, decode: bool,
               fresh: bool):
    return x + ll.ssd_block(p.ssd, cfg, ll.rms_norm(x, p.norm, cfg.norm_eps),
                            cache=c, decode=decode, fresh=fresh)


def _rglru_layer(p, cfg: ModelConfig, x, c: Optional[Dict], *,
                 decode: bool):
    x = x + ll.rglru_block(p.rglru, cfg,
                           ll.rms_norm(x, p.mix_norm, cfg.norm_eps),
                           cache=c, decode=decode)
    return x + ll.glu_ffn(p.ffn, ll.rms_norm(x, p.ffn_norm, cfg.norm_eps))


def _layer(p, cfg: ModelConfig, x, positions, c: Optional[Dict], *,
           decode: bool, fresh: bool):
    if isinstance(p, SSDBlock):
        return _ssd_layer(p, cfg, x, c, decode=decode, fresh=fresh)
    if isinstance(p, RGLRUBlock):
        return _rglru_layer(p, cfg, x, c, decode=decode)
    return _dense_layer(p, cfg, x, positions, c, decode=decode)


def _backbone(params: DenseModel, cfg: ModelConfig, x, positions,
              cache: Optional[Dict], *, decode: bool, fresh: bool = False,
              remat: bool = False):
    """The blocks in order. ``remat``: each layer under
    ``torch.utils.checkpoint`` (its activations recomputed in the
    backward), the counterpart of ``jax.checkpoint`` on the scan body."""
    for i, p in enumerate(params.blocks):
        c = _layer_cache(cfg, cache, i)
        if remat:
            x = checkpoint(_layer, p, cfg, x, positions, c, decode=decode,
                           fresh=fresh, use_reentrant=False)
        else:
            x = _layer(p, cfg, x, positions, c, decode=decode, fresh=fresh)
    return x, _advance(cache, x.shape[1])


def _fresh(cfg: ModelConfig, cache: Optional[Dict]) -> bool:
    """Whether a prefill starts from the zero recurrent state: no cache,
    or one no token has entered yet (``len`` 0 everywhere, as
    ``init_cache`` makes it). Only the ssm family asks (one host sync a
    prefill); a prefill that continues a state takes the plain scan."""
    if cache is None or cfg.family != "ssm":
        return True
    return not bool(cache["len"].any())


def _check_decode(cfg: ModelConfig, T: int) -> None:
    if T > 1 and cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"multi-token decode unsupported for {cfg.family}")


def _check_frames(cfg: ModelConfig, embeds) -> None:
    if cfg.family == "audio" and embeds is None:
        raise ValueError(f"{cfg.name} encodes audio frames: pass them as "
                         f"embeds (B, {cfg.n_frontend_tokens}, d)")


def train_forward(params: DenseModel, cfg: ModelConfig,
                  tokens: torch.Tensor, *,
                  embeds: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  remat: bool = False) -> torch.Tensor:
    """``forward`` without ``no_grad``: the body the trainer
    differentiates (``runtime.train.lm_loss``). ``remat``: see
    ``_backbone`` (whisper's stacks take none, as in the reference)."""
    _check_frames(cfg, embeds)
    if cfg.family == "audio":
        return _whisper_forward(params, cfg, tokens, embeds)
    x = _embed_input(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    if positions is None:
        positions = default_positions(cfg, B, S)
    x, _ = _backbone(params, cfg, x, positions.to(x.device), None,
                     decode=False, remat=remat)
    x = ll.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x)


@torch.no_grad()
def forward(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence logits (B, S, V), no cache. ``embeds``: frontend
    embeddings prepended to the tokens' (vlm patches), or whisper's
    frames."""
    return train_forward(params, cfg, tokens, embeds=embeds,
                         positions=positions)


@torch.no_grad()
def prefill(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict, *, embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt (after ``embeds``, if given), fill the cache,
    return last-position logits."""
    _check_frames(cfg, embeds)
    if cfg.family == "audio":
        return whisper_prefill(params, cfg, tokens, embeds, cache)
    x = _embed_input(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    if positions is None:
        positions = default_positions(cfg, B, S)
    x, new_cache = _backbone(params, cfg, x, positions.to(x.device), cache,
                             decode=False, fresh=_fresh(cfg, cache))
    x = ll.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x), new_cache


@torch.no_grad()
def decode_step(params: DenseModel, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step over the dense cache. tokens: (B, T); T > 1 is the
    speculative verify pass (causal among the T tokens; roll rejected
    positions back with ``rollback_cache``), for the KV families only:
    recurrent state cannot roll back."""
    B, T = tokens.shape
    _check_decode(cfg, T)
    if cfg.family == "audio":
        return whisper_decode_step(params, cfg, cache, tokens)
    x = embed_tokens(params, cfg, tokens)
    pos = default_positions(cfg, B, T, cache["len"])
    x, new_cache = _backbone(params, cfg, x, pos, cache, decode=True)
    x = ll.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x), new_cache


# --------------------------------------------------------------------------- #
#  layer-wise paths: weights pulled from a ParamSource one layer at a time
# --------------------------------------------------------------------------- #

#: leaf names whose consumers route through ``layers.qmm``: the only sites
#: where a packed weight may survive into the block functions
_FUSED_Q4_KEYS = frozenset((
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "in_proj", "out_proj"))


def _dequant_params(p: Dict) -> types.SimpleNamespace:
    """The head tree (embed, final_norm[, unembed]) with any quantized
    leaf dequantized to f32, as attributes."""
    return types.SimpleNamespace(**dequantize_tree(p, torch.float32))


def _prepare_layer_params(p: Dict) -> Dict:
    """Selective dequantization for the layer-wise path: quantized
    projection weights stay packed for ``layers.qmm`` (which sends each
    to kernel B3 or dequantizes it at use); any other quantized leaf
    dequantizes to f32 here."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = _prepare_layer_params(v)
        elif isinstance(v, QuantizedTensor) and k not in _FUSED_Q4_KEYS:
            out[k] = dequantize_leaf(v, torch.float32)
        else:
            out[k] = v
    return out


def _layerwise_backbone(source, cfg: ModelConfig, x, positions,
                        cache: Optional[Dict], *, decode: bool,
                        fresh: bool = False):
    """The stack one layer at a time, weights pulled from ``source``; the
    dense cache's layer ``i`` is written in place."""
    if cfg.family not in STACKED_FAMILIES:
        raise ValueError(f"layer-wise streaming unsupported for family "
                         f"{cfg.family}")
    from ..bridge import block_from_tree

    for i in range(cfg.n_layers):
        p = block_from_tree(_prepare_layer_params(source.layer(i)))
        x = _layer(p, cfg, x, positions, _layer_cache(cfg, cache, i),
                   decode=decode, fresh=fresh)
    return x, _advance(cache, x.shape[1])


@torch.no_grad()
def forward_layerwise(source, cfg: ModelConfig, tokens: torch.Tensor, *,
                      embeds: Optional[torch.Tensor] = None,
                      positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``forward`` with weights pulled from a ParamSource."""
    head = _dequant_params(source.head())
    x = _embed_input(head, cfg, tokens, embeds)
    B, S, _ = x.shape
    if positions is None:
        positions = default_positions(cfg, B, S)
    x, _ = _layerwise_backbone(source, cfg, x, positions.to(x.device), None,
                               decode=False)
    x = ll.rms_norm(x, head.final_norm, cfg.norm_eps)
    return unembed(head, cfg, x)


@torch.no_grad()
def prefill_layerwise(source, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: Dict, *, embeds: Optional[torch.Tensor] = None,
                      positions: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """``prefill`` with weights pulled from a ParamSource."""
    head = _dequant_params(source.head())
    x = _embed_input(head, cfg, tokens, embeds)
    B, S, _ = x.shape
    if positions is None:
        positions = default_positions(cfg, B, S)
    x, new_cache = _layerwise_backbone(source, cfg, x,
                                       positions.to(x.device), cache,
                                       decode=False,
                                       fresh=_fresh(cfg, cache))
    x = ll.rms_norm(x[:, -1:], head.final_norm, cfg.norm_eps)
    return unembed(head, cfg, x), new_cache


@torch.no_grad()
def decode_step_layerwise(source, cfg: ModelConfig, cache: Dict,
                          tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """``decode_step`` with weights pulled from a ParamSource. tokens:
    (B, T); T > 1 (the KV families) is a verify pass that reads each
    layer once for the whole block."""
    B, T = tokens.shape
    _check_decode(cfg, T)
    head = _dequant_params(source.head())
    x = embed_tokens(head, cfg, tokens)
    x, new_cache = _layerwise_backbone(
        source, cfg, x, default_positions(cfg, B, T, cache["len"]), cache,
        decode=True)
    x = ll.rms_norm(x, head.final_norm, cfg.norm_eps)
    return unembed(head, cfg, x), new_cache


# --------------------------------------------------------------------------- #
#  paged KV-cache paths (block-pool cache, runtime.kvcache)
# --------------------------------------------------------------------------- #

def _check_paged(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"paged {what} unsupported for {cfg.family}")


def _paged_backbone(params: DenseModel, cfg: ModelConfig, x, positions,
                    cache: Dict, *, prefill: bool = False,
                    write: bool = True):
    ln = cache["len"]
    table = cache["block_table"]
    pages = cache["pages"]
    for i, p in enumerate(params.blocks):
        pg = {name: arr[i] for name, arr in pages.items()}
        h_in = ll.rms_norm(x, p.attn_norm, cfg.norm_eps)
        if cfg.mla:
            x = x + ll.mla_block_paged(p.attn, cfg, h_in, positions, pg,
                                       table, ln, write=write)
        else:
            x = x + ll.attn_block_paged(p.attn, cfg, h_in, positions, pg,
                                        table, ln, prefill=prefill,
                                        write=write)
        x = x + ll.block_ffn(p, cfg, ll.rms_norm(x, p.ffn_norm, cfg.norm_eps),
                             lossless=True)
    return x, {**cache, "len": ln + x.shape[1]}


@torch.no_grad()
def decode_step_paged(params: DenseModel, cfg: ModelConfig, cache: Dict,
                      tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """``decode_step`` against a paged KV cache. tokens: (B, T)."""
    _check_paged(cfg, "decode")
    B, T = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    x, new_cache = _paged_backbone(
        params, cfg, x, default_positions(cfg, B, T, cache["len"]), cache)
    x = ll.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x), new_cache


@torch.no_grad()
def prefill_chunk_paged(params: DenseModel, cfg: ModelConfig, cache: Dict,
                        tokens: torch.Tensor, *, write: bool = True
                        ) -> Tuple[torch.Tensor, Dict]:
    """One chunk of a chunked (paged) prefill. tokens: (B, S).

    ``cache`` is a per-slot view ({"pages", "block_table", "len"}) whose
    ``len`` counts the prompt positions already in pages; the chunk's KV
    is written through the table and attention runs with the dense-prefill
    math (MLA: its absorbed paged path, which is already chunk-causal).
    Returns full (B, S, V) logits. ``write=False`` re-derives logits
    without touching pages (a whole-prompt prefix hit).
    """
    _check_paged(cfg, "prefill")
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    x, new_cache = _paged_backbone(
        params, cfg, x, default_positions(cfg, B, S, cache["len"]), cache,
        prefill=True, write=write)
    x = ll.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x), new_cache


def rollback_cache(cache: Dict, new_len) -> Dict:
    """Roll rejected speculative positions out of a KV cache: entries past
    ``len`` are never attended, so this resets the counter, in place (a
    step replayed from a CUDA graph reads the same ``len`` tensor)."""
    cache["len"].copy_(torch.as_tensor(new_len))
    return cache


# --------------------------------------------------------------------------- #
#  whisper (encoder-decoder)
# --------------------------------------------------------------------------- #

def whisper_encode(params: WhisperModel, cfg: ModelConfig,
                   frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d) mel-frame embeddings (the conv frontend is a
    stub) -> the encoder's output (B, F, d): bidirectional attention,
    plain torch."""
    B, F, d = frames.shape
    x = frames + sinusoid_positions(F, d, frames.dtype, frames.device)[None]
    positions = default_positions(cfg, B, F).to(x.device)
    for p in params.enc_blocks:
        a, _ = ll.attn_block(p.attn, cfg,
                             ll.rms_norm(x, p.attn_norm, cfg.norm_eps),
                             positions, causal=False)
        x = x + a
        x = x + ll.glu_ffn(p.ffn, ll.rms_norm(x, p.ffn_norm, cfg.norm_eps))
    return ll.rms_norm(x, params.enc_norm, cfg.norm_eps)


def _cross_kv(p, cfg: ModelConfig, enc_out: torch.Tensor):
    B, F, _ = enc_out.shape
    hk, hd = cfg.kv_heads, cfg.head_dim
    return ((enc_out @ p.wk).reshape(B, F, hk, hd),
            (enc_out @ p.wv).reshape(B, F, hk, hd))


def _dec_layer(p: DecBlock, cfg: ModelConfig, x, positions, c, ck, cv, *,
               decode: bool):
    """Whisper's decoder layer: self attention (a decode through
    ``layers._dense_attention``, kernel B5 on the card), cross attention
    over (ck, cv), GLU."""
    a, _ = ll.attn_block(p.attn, cfg,
                         ll.rms_norm(x, p.attn_norm, cfg.norm_eps),
                         positions, cache=c, decode=decode)
    x = x + a
    a, _ = ll.attn_block(p.cross, cfg,
                         ll.rms_norm(x, p.cross_norm, cfg.norm_eps),
                         positions, cross_kv=(ck, cv), causal=False)
    x = x + a
    return x + ll.glu_ffn(p.ffn, ll.rms_norm(x, p.ffn_norm, cfg.norm_eps))


def _dec_input(params, cfg: ModelConfig, tokens):
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    x = x + sinusoid_positions(S, cfg.d_model, x.dtype, x.device)[None]
    return x, default_positions(cfg, B, S).to(x.device)


def _whisper_forward(params: WhisperModel, cfg: ModelConfig, tokens,
                     frames) -> torch.Tensor:
    enc_out = whisper_encode(params, cfg, frames)
    x, positions = _dec_input(params, cfg, tokens)
    for p in params.blocks:
        ck, cv = _cross_kv(p.cross, cfg, enc_out)
        x = _dec_layer(p, cfg, x, positions, None, ck, cv, decode=False)
    x = ll.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x)


@torch.no_grad()
def whisper_forward(params: WhisperModel, cfg: ModelConfig, tokens,
                    frames) -> torch.Tensor:
    return _whisper_forward(params, cfg, tokens, frames)


@torch.no_grad()
def whisper_prefill(params: WhisperModel, cfg: ModelConfig, tokens, frames,
                    cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Encode ``frames``, keep every decoder layer's cross K/V in the
    cache, and prefill the decoder's self-attention lines."""
    enc_out = whisper_encode(params, cfg, frames)
    x, positions = _dec_input(params, cfg, tokens)
    for i, p in enumerate(params.blocks):
        ck, cv = _cross_kv(p.cross, cfg, enc_out)
        cache["cross_k"][i] = ck
        cache["cross_v"][i] = cv
        x = _dec_layer(p, cfg, x, positions, _layer_cache(cfg, cache, i),
                       ck, cv, decode=False)
    x = ll.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x), _advance(cache, tokens.shape[1])


@torch.no_grad()
def whisper_decode_step(params: WhisperModel, cfg: ModelConfig, cache: Dict,
                        tokens) -> Tuple[torch.Tensor, Dict]:
    """One decoder token a sequence over the self-attention lines and the
    cached cross K/V; its absolute position is ``len`` (the table's last
    row past ``max_decode_len``)."""
    ln = cache["len"]
    x = embed_tokens(params, cfg, tokens)
    S_tab = cfg.max_decode_len or cache["layers"]["k"].shape[2]
    table = sinusoid_positions(S_tab, cfg.d_model, x.dtype, x.device)
    x = x + table[torch.clamp(ln, max=S_tab - 1).long()][:, None]
    positions = ln[:, None]
    for i, p in enumerate(params.blocks):
        x = _dec_layer(p, cfg, x, positions, _layer_cache(cfg, cache, i),
                       cache["cross_k"][i], cache["cross_v"][i], decode=True)
    x = ll.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x), _advance(cache, 1)
