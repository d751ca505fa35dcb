"""Model assembly of the port: the dense GQA, moe and ssm (Mamba-2)
families, init / forward / prefill / decode over a dense cache (dense GQA
and moe also over a paged KV cache), with resident weights or layer by
layer from a ``ParamSource`` (the streamed path).

Counterpart of ``repro.models.model`` for those three families.
Parameters are ``nn.Module``s (``DenseModel`` > ``DenseBlock`` >
``Attention`` and ``GLU`` or ``MoE``, or ``DenseModel`` > ``SSDBlock`` >
``SSD``) whose tensors keep the JAX pytree's names and (in, out) layouts;
a Python loop over ``blocks`` takes the place of ``lax.scan``. A moe
block's dispatch drops rows over capacity where the JAX package's does:
in a dense or layer-wise prefill (``moe_capacity_factor``; None, as the
reduced configs set it, drops nothing); decode, the paged paths and the
ring run lossless.

Caches (device tensors, written in place):

  dense : {"len": (B,), "layers": {"k"/"v": (L, B, S_max, h_kv, hd)
           [+ "k_scale"/"v_scale": (L, B, S_max, h_kv)]}}
  ssm   : {"len": (B,), "layers": {"conv": (L, B, K-1, di+2N),
           "state": (L, B, nh, P, N)}}
  paged : {"pages": {leaf: (L, P, bs, ...)}, "block_table": (B, nb),
           "len": (B,)}  (built by ``runtime.kvcache.PagedKVCache``;
           dense GQA and moe)

Every function returns a new cache dict (``len`` advanced) over the same
tensors, so callers keep the JAX package's ``cache = f(cache, ...)`` flow
(``rollback_cache`` resets ``len`` in place, and the graphed steps of
``runtime`` write the advanced ``len`` into the cache's own tensor).
An ssm prefill into a cache no token has entered yet (``len`` 0
everywhere: ``init_cache``'s zero state) runs the SSD scan through kernel
B6 on the card; the recurrent state cannot roll back, so decode takes one
token a sequence (T = 1), as in the JAX package.

The layer-wise paths (``forward_layerwise``, ``prefill_layerwise``,
``decode_step_layerwise``) pull each layer's tree from
``source.layer(i)`` (``runtime.paramstore`` / ``runtime.streaming``). A
q4 ``QuantizedTensor`` under a projection key stays packed and goes
through ``layers.qmm`` (kernel B3 on the card), a q4 expert stack through
``layers.expert_mm`` (B3 once an expert); any other quantized leaf is
dequantized when its layer is pulled.
"""
from __future__ import annotations

import math
import types
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..quant.grouped import QuantizedTensor, dequantize_leaf, dequantize_tree
from . import layers as ll


def _param(t):
    """A frozen parameter; a packed ``QuantizedTensor`` stays a plain
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
    """Attention and an FFN: ``GLU`` (held as ``ffn``) or ``MoE`` (held as
    ``moe``, the JAX tree's key)."""

    def __init__(self, attn_norm, attn: Attention, ffn_norm, ffn):
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


class DenseModel(nn.Module):
    """Embedding, a stack of blocks (``DenseBlock`` or ``SSDBlock``), final
    norm and (untied) unembedding."""

    def __init__(self, embed, final_norm, blocks, unembed=None):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = _param(final_norm)
        self.blocks = nn.ModuleList(blocks)
        if unembed is not None:
            self.unembed = _param(unembed)


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


#: the families the port serves, and where the others wait
FAMILIES = ("dense", "moe", "ssm")
MISSING_FAMILIES = ("MLA (minicpm3), vlm (qwen2-vl-2b), hybrid "
                    "(recurrentgemma-9b) and audio (whisper-tiny) are "
                    "ROADMAP Queue A item 5")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or cfg.mla:
        raise NotImplementedError(
            f"the port serves the dense GQA, moe and ssm families (got "
            f"{cfg.name}, family {cfg.family}); {MISSING_FAMILIES}")


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


def init_block(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32, device="cuda"):
    """One block's random weights, drawn from ``generator``: a dense block
    (normal scaled by 1/sqrt(fan-in), zero biases, unit norms; attention,
    then the GLU or the MoE's router, w_gate, w_up and w_down, the JAX
    init's order), or an SSD block (projections as dense, conv_w normal x
    0.1, dt_bias 0, a_log log(linspace(1, 16, nh)), d_skip 1, unit
    norms)."""
    _check_family(cfg)
    normal, ones, zeros = _draws(generator, dtype, device)
    if cfg.family == "ssm":
        return _init_ssd_block(cfg, normal, ones, zeros, dtype, device)
    d, H, hk, hd, f = (cfg.d_model, cfg.n_heads, cfg.kv_heads,
                       cfg.head_dim, cfg.d_ff)
    s = 1.0 / math.sqrt(d)
    bias = (zeros(H * hd), zeros(hk * hd), zeros(hk * hd)) \
        if cfg.qkv_bias else ()
    attn = Attention(normal((d, H * hd), s), normal((d, hk * hd), s),
                     normal((d, hk * hd), s), normal((H * hd, d), s), *bias)
    if cfg.n_experts:
        E = cfg.n_experts
        ffn = MoE(normal((d, E), s), normal((E, d, f), s),
                  normal((E, d, f), s), normal((E, f, d), 1.0 / math.sqrt(f)))
    else:
        ffn = GLU(normal((d, f), s), normal((d, f), s),
                  normal((f, d), 1.0 / math.sqrt(f)))
    return DenseBlock(ones(d), attn, ones(d), ffn)


def init_head(cfg: ModelConfig, generator: torch.Generator,
              dtype=torch.float32, device="cuda") -> Dict[str, torch.Tensor]:
    """The non-block weights: {"embed" (x0.02), "final_norm" (ones)[,
    "unembed" (1/sqrt(d)) unless tied]}."""
    _check_family(cfg)
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
    ``device``): the blocks in order, then the head."""
    _check_family(cfg)
    blocks = [init_block(cfg, generator, dtype, device)
              for _ in range(cfg.n_layers)]
    head = init_head(cfg, generator, dtype, device)
    return DenseModel(head["embed"], head["final_norm"], blocks,
                      head.get("unembed"))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda") -> Dict:
    """The dense (L, B, max_len, ...) cache (int8 K/V + bf16 scales when
    ``cfg.kv_dtype == "int8"``), or the ssm family's conv window and
    recurrent state (zero; their size does not depend on ``max_len``)."""
    if cfg.family == "ssm":
        L, di, N, P = cfg.n_layers, cfg.d_inner, cfg.ssm_state, \
            cfg.ssm_head_dim
        layers = {"conv": torch.zeros((L, batch, cfg.conv_width - 1,
                                       di + 2 * N), dtype=dtype,
                                      device=device),
                  "state": torch.zeros((L, batch, di // P, P, N),
                                       dtype=dtype, device=device)}
        return {"len": torch.zeros((batch,), dtype=torch.int32,
                                   device=device), "layers": layers}
    L, hk, hd = cfg.n_layers, max(cfg.kv_heads, 1), cfg.head_dim
    S = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    shape = (L, batch, S, hk, hd)
    if cfg.kv_dtype == "int8":
        layers = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                  "v": torch.zeros(shape, dtype=torch.int8, device=device),
                  "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                         device=device),
                  "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                         device=device)}
    else:
        layers = {"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "layers": layers}


# --------------------------------------------------------------------------- #
#  embeddings / forward paths
# --------------------------------------------------------------------------- #

def embed_tokens(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params.embed[tokens.long()]


def unembed(params: DenseModel, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    if hasattr(params, "unembed"):
        return x @ params.unembed
    return x @ params.embed.T


def _positions(ln: torch.Tensor, T: int) -> torch.Tensor:
    return ln[:, None] + torch.arange(T, dtype=ln.dtype,
                                      device=ln.device)[None]


def _layer_cache(cache: Optional[Dict], i: int) -> Optional[Dict]:
    """Layer ``i``'s views of a dense cache (written in place)."""
    if cache is None:
        return None
    c = {name: arr[i] for name, arr in cache["layers"].items()}
    c["len"] = cache["len"]
    return c


def _advance(cache: Optional[Dict], n: int) -> Optional[Dict]:
    return None if cache is None else {**cache, "len": cache["len"] + n}


def _dense_layer(p, cfg: ModelConfig, x, positions, c: Optional[Dict], *,
                 decode: bool):
    h, _ = ll.attn_block(p.attn, cfg, ll.rms_norm(x, p.attn_norm,
                                                  cfg.norm_eps),
                         positions, cache=c, decode=decode)
    x = x + h
    return x + ll.block_ffn(p, cfg, ll.rms_norm(x, p.ffn_norm, cfg.norm_eps),
                            lossless=decode)


def _ssd_layer(p, cfg: ModelConfig, x, c: Optional[Dict], *, decode: bool,
               fresh: bool):
    return x + ll.ssd_block(p.ssd, cfg, ll.rms_norm(x, p.norm, cfg.norm_eps),
                            cache=c, decode=decode, fresh=fresh)


def _layer(p, cfg: ModelConfig, x, positions, c: Optional[Dict], *,
           decode: bool, fresh: bool):
    if cfg.family == "ssm":
        return _ssd_layer(p, cfg, x, c, decode=decode, fresh=fresh)
    return _dense_layer(p, cfg, x, positions, c, decode=decode)


def _backbone(params: DenseModel, cfg: ModelConfig, x, positions,
              cache: Optional[Dict], *, decode: bool, fresh: bool = False):
    for i, p in enumerate(params.blocks):
        x = _layer(p, cfg, x, positions, _layer_cache(cache, i),
                   decode=decode, fresh=fresh)
    return x, _advance(cache, x.shape[1])


def _prefill_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def _fresh(cfg: ModelConfig, cache: Optional[Dict]) -> bool:
    """Whether a prefill starts from the zero recurrent state: no cache,
    or one no token has entered yet (``len`` 0 everywhere, as
    ``init_cache`` makes it). Only the ssm family asks (one host sync a
    prefill); a prefill that continues a state takes the plain scan."""
    if cache is None or cfg.family != "ssm":
        return True
    return not bool(cache["len"].any())


def _check_decode(cfg: ModelConfig, T: int) -> None:
    if T > 1 and cfg.family not in ("dense", "moe"):
        raise ValueError(f"multi-token decode unsupported for {cfg.family}")


@torch.no_grad()
def forward(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Full-sequence logits (B, S, V), no cache."""
    x = embed_tokens(params, cfg, tokens)
    B, S, _ = x.shape
    x, _ = _backbone(params, cfg, x, _prefill_positions(B, S, x.device),
                     None, decode=False)
    x = ll.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x)


@torch.no_grad()
def prefill(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt, fill the cache, return last-position logits."""
    x = embed_tokens(params, cfg, tokens)
    B, S, _ = x.shape
    x, new_cache = _backbone(params, cfg, x,
                             _prefill_positions(B, S, x.device), cache,
                             decode=False, fresh=_fresh(cfg, cache))
    x = ll.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x), new_cache


@torch.no_grad()
def decode_step(params: DenseModel, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step over the dense cache. tokens: (B, T); T > 1 is the
    speculative verify pass (causal among the T tokens; roll rejected
    positions back with ``rollback_cache``), dense and moe only: recurrent
    state cannot roll back."""
    T = tokens.shape[1]
    _check_decode(cfg, T)
    x = embed_tokens(params, cfg, tokens)
    pos = _positions(cache["len"], T)
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
    if cfg.family not in FAMILIES or cfg.mla:
        raise ValueError(f"layer-wise streaming unsupported for family "
                         f"{cfg.family} (the port streams dense GQA, moe "
                         f"and ssm models; {MISSING_FAMILIES})")
    from ..bridge import block_from_tree

    for i in range(cfg.n_layers):
        p = block_from_tree(_prepare_layer_params(source.layer(i)))
        x = _layer(p, cfg, x, positions, _layer_cache(cache, i),
                   decode=decode, fresh=fresh)
    return x, _advance(cache, x.shape[1])


@torch.no_grad()
def forward_layerwise(source, cfg: ModelConfig, tokens: torch.Tensor
                      ) -> torch.Tensor:
    """``forward`` with weights pulled from a ParamSource."""
    head = _dequant_params(source.head())
    x = embed_tokens(head, cfg, tokens)
    B, S, _ = x.shape
    x, _ = _layerwise_backbone(source, cfg, x,
                               _prefill_positions(B, S, x.device), None,
                               decode=False)
    x = ll.rms_norm(x, head.final_norm, cfg.norm_eps)
    return unembed(head, cfg, x)


@torch.no_grad()
def prefill_layerwise(source, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """``prefill`` with weights pulled from a ParamSource."""
    head = _dequant_params(source.head())
    x = embed_tokens(head, cfg, tokens)
    B, S, _ = x.shape
    x, new_cache = _layerwise_backbone(source, cfg, x,
                                       _prefill_positions(B, S, x.device),
                                       cache, decode=False,
                                       fresh=_fresh(cfg, cache))
    x = ll.rms_norm(x[:, -1:], head.final_norm, cfg.norm_eps)
    return unembed(head, cfg, x), new_cache


@torch.no_grad()
def decode_step_layerwise(source, cfg: ModelConfig, cache: Dict,
                          tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """``decode_step`` with weights pulled from a ParamSource. tokens:
    (B, T); T > 1 (dense and moe) is a verify pass that reads each
    layer once for the whole block."""
    T = tokens.shape[1]
    _check_decode(cfg, T)
    head = _dequant_params(source.head())
    x = embed_tokens(head, cfg, tokens)
    x, new_cache = _layerwise_backbone(source, cfg, x,
                                       _positions(cache["len"], T), cache,
                                       decode=True)
    x = ll.rms_norm(x, head.final_norm, cfg.norm_eps)
    return unembed(head, cfg, x), new_cache


def _paged_backbone(params: DenseModel, cfg: ModelConfig, x, positions,
                    cache: Dict, *, prefill: bool = False,
                    write: bool = True):
    ln = cache["len"]
    table = cache["block_table"]
    pages = cache["pages"]
    for i, p in enumerate(params.blocks):
        pg = {name: arr[i] for name, arr in pages.items()}
        h_in = ll.rms_norm(x, p.attn_norm, cfg.norm_eps)
        x = x + ll.attn_block_paged(p.attn, cfg, h_in, positions, pg, table,
                                    ln, prefill=prefill, write=write)
        x = x + ll.block_ffn(p, cfg, ll.rms_norm(x, p.ffn_norm, cfg.norm_eps),
                             lossless=True)
    return x, {**cache, "len": ln + x.shape[1]}


@torch.no_grad()
def decode_step_paged(params: DenseModel, cfg: ModelConfig, cache: Dict,
                      tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """``decode_step`` against a paged KV cache. tokens: (B, T)."""
    T = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    x, new_cache = _paged_backbone(params, cfg, x,
                                   _positions(cache["len"], T), cache)
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
    math. Returns full (B, S, V) logits. ``write=False`` re-derives logits
    without touching pages (a whole-prompt prefix hit).
    """
    S = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    x, new_cache = _paged_backbone(params, cfg, x,
                                   _positions(cache["len"], S), cache,
                                   prefill=True, write=write)
    x = ll.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x), new_cache


def rollback_cache(cache: Dict, new_len) -> Dict:
    """Roll rejected speculative positions out of a KV cache: entries past
    ``len`` are never attended, so this resets the counter, in place (a
    step replayed from a CUDA graph reads the same ``len`` tensor)."""
    cache["len"].copy_(torch.as_tensor(new_len))
    return cache
