"""Layer library of the port: ``repro.models.layers`` in PyTorch (GQA
attention with RoPE or M-RoPE, MLA, the GLU and MoE FFNs, the RG-LRU,
Mamba-2, and the paged-cache paths).

Functions over tensors and parameter modules (``models.model``), at the
JAX package's layouts so the tests compare like with like:

  x            : (B, S, d) activations
  attn cache   : k/v (B, S_max, h_kv, hd)  [+ int8 scales if quantized]
  MLA cache    : latent (B, S_max, r_kv + rope dims)
  page pool    : k/v (P, bs, h_kv, hd)     [+ (P, bs, h_kv) scales],
                 MLA: latent (P, bs, r_kv + rope dims)
  positions    : (B, S) int absolute positions (M-RoPE: (3, B, S))

Cache writes are in place (the JAX package's ``.at[].set`` returns a new
array): at full width a functional copy of a (P, bs, 8, 128) page pool per
layer per step would cost more than the step itself. Weights keep JAX's
(in, out) layout, so ``x @ w`` is the same product; every projection
goes through ``qmm``, so a weight may also be a packed q4
``QuantizedTensor`` (the streamed layer-wise path).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..quant.grouped import QuantizedTensor, dequantize_leaf

Pages = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- #
#  basics
# --------------------------------------------------------------------------- #

def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` at the promoted dtype, as jnp promotes a mixed product
    (bf16 activations against a weight dequantized to f32 give f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def q4_kernel_eligible(w) -> bool:
    """Whether a ``QuantizedTensor`` goes to the Hopper kernel B3: 2-D q4
    packing with K even and a multiple of the group. The kernel masks
    ragged M and N edges, so any M and N go (the JAX package's
    ``q4_fused_eligible`` adds the TPU's tile rules, which do not apply
    here)."""
    if w.bits != 4 or w.packed.dim() != 2:
        return False
    K = w.packed.shape[0] * 2
    return w.group >= 1 and K % w.group == 0


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul against a weight that may still be packed.

    A plain tensor takes ``@`` at the promoted dtype (``_matmul``, as jnp
    promotes). A ``QuantizedTensor`` that ``q4_kernel_eligible`` accepts
    goes to ``kernels.ops.q4_matmul`` (kernel B3 on the card, its plain
    version on the CPU) for any number of rows; anything else (q2,
    stacked 3-D leaves) dequantizes at use; either way its result comes
    back in ``x.dtype``.
    """
    if not isinstance(w, QuantizedTensor):
        return _matmul(x, w)
    *lead, K = x.shape
    if q4_kernel_eligible(w):
        from ..kernels import ops

        out = ops.q4_matmul(x.reshape(-1, K).contiguous(), w.packed,
                            w.scale, group=w.group)
        return out.reshape(*lead, out.shape[-1]).to(x.dtype)
    return x @ dequantize_leaf(w, torch.float32).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMSNorm with f32 statistics, result in x.dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` at the promoted dtype, as ``jnp.einsum`` promotes
    a mixed pair (bf16 activations against a weight dequantized to f32
    give f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, h, d); positions: (B, S). Trig in f32, rotation in
    x.dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    ang = positions[..., None].float() * freqs               # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Qwen2-VL 3-D rotary sections (t, h, w) summing to head_dim // 2."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float
                ) -> torch.Tensor:
    """M-RoPE: positions3 (3, B, S), the temporal, height and width
    streams. RoPE's frequency layout; frequency index i turns by the
    stream of its section (``mrope_sections``)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    sec_id = torch.cat([torch.full((n,), i, device=x.device)
                        for i, n in enumerate(mrope_sections(d))])  # (d/2,)
    pos = positions3.float()[sec_id].permute(1, 2, 0)        # (B, S, d/2)
    ang = pos * freqs
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def rotate(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """RoPE, or M-RoPE for a ``cfg.mrope`` model (positions (3, B, S))."""
    if cfg.mrope:
        return apply_mrope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


# --------------------------------------------------------------------------- #
#  attention — chunked causal (prefill) and cached decode/verify
# --------------------------------------------------------------------------- #

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, h_kv, d) -> (B, S, h_kv*n_rep, d) (GQA broadcast)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             window: Optional[int] = None,
                             q_offset: int = 0,
                             chunk: int = 512) -> torch.Tensor:
    """Flash-style double-chunked causal attention (plain torch).

    q: (B, Sq, H, D); k, v: (B, Sk, h_kv, D). Online softmax over KV
    chunks, as the JAX function scans them. ``window``: sliding-window
    size (None = full causal); ``q_offset``: absolute position of q[0]
    relative to k[0].
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    n_rep = H // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(D)
    if q.device.type == "meta":
        # the dry run: meta tensors store and compute nothing, and one
        # tile has the same result shape as the loop's thousands
        chunk = max(Sq, Sk, 1)
    qc = kc = chunk
    n_q = -(-Sq // qc)
    n_k = -(-Sk // kc)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, n_q * qc - Sq))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, n_k * kc - Sk))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n_k * kc - Sk))
    # (B, H, n, c, D)
    qb = q.reshape(B, n_q, qc, H, D).permute(0, 3, 1, 2, 4) * scale
    kb = k.reshape(B, n_k, kc, H, D).permute(0, 3, 1, 2, 4)
    vb = v.reshape(B, n_k, kc, H, D).permute(0, 3, 1, 2, 4)
    dev = q.device
    q_pos = q_offset + torch.arange(n_q * qc, device=dev)
    k_pos = torch.arange(n_k * kc, device=dev)
    outs = []
    for qi in range(n_q):
        q_tile = qb[:, :, qi]
        acc = torch.zeros((B, H, qc, D), dtype=torch.float32, device=dev)
        m = torch.full((B, H, qc), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=dev)
        qp = q_pos[qi * qc:(qi + 1) * qc]
        for ki in range(n_k):
            s = torch.einsum("bhqd,bhkd->bhqk", q_tile,
                             kb[:, :, ki]).float()
            kp = k_pos[ki * kc:(ki + 1) * kc]
            mask = qp[:, None] >= kp[None, :]
            if window is not None:
                mask &= (qp[:, None] - kp[None, :]) < window
            mask &= kp[None, :] < Sk
            s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                               0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vb[:, :, ki].float())
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, 0)                          # (nq, B, H, qc, D)
    out = out.permute(1, 0, 3, 2, 4).reshape(B, n_q * qc, H, D)
    return out[:, :Sq].to(q.dtype)


def verify_attention_stats(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_len: torch.Tensor,
                           *, window: Optional[int] = None, pos_offset=0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Multi-query attention stats against a cache.

    q: (B, T, H, D); query t sits at ``kv_len - T + t`` and attends
    causally. k_cache/v_cache: (B, S, h_kv, D). Returns acc (B, H, T, D)
    [unnormalized], m (B, H, T), l (B, H, T).
    """
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    n_rep = H // k_cache.shape[2]
    k = _repeat_kv(k_cache, n_rep)
    v = _repeat_kv(v_cache, n_rep)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    dev = q.device
    pos = torch.arange(S, device=dev) + pos_offset                # (S,)
    qpos = kv_len.long()[:, None] - T + torch.arange(T, device=dev)[None]
    mask = pos[None, None, :] <= qpos[:, :, None]                 # (B,T,S)
    if window is not None:
        mask &= pos[None, None, :] > (qpos[:, :, None] - window)
    s = torch.where(mask[:, None], s, -math.inf)
    m = s.amax(-1)                                                # (B,H,T)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask[:, None], torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhts,bshd->bhtd", p, v.float())
    return acc, m, l


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor,
                     *, window: Optional[int] = None) -> torch.Tensor:
    """Multi-position attention against a cache: (B, T, H, D) -> same."""
    acc, m, l = verify_attention_stats(q, k_cache, v_cache, kv_len,
                                       window=window)
    out = acc / torch.clamp(l[..., None], min=1e-30)              # (B,H,T,D)
    return out.transpose(1, 2).to(q.dtype)


def decode_attention_stats(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_len: torch.Tensor,
                           *, window: Optional[int] = None, pos_offset=0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Single-query stats: the T = 1 slice of ``verify_attention_stats``.
    q: (B, 1, H, D) -> acc (B, H, D) [unnormalized], m (B, H), l (B, H)."""
    acc, m, l = verify_attention_stats(q, k_cache, v_cache, kv_len,
                                       window=window, pos_offset=pos_offset)
    return acc[:, :, 0], m[:, :, 0], l[:, :, 0]


def stats_to_lse(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``verify_attention_stats``' (acc, m, l) as (o (B, T, H, D) in
    ``dtype``, lse (B, H, T) f32): the normalized output and each row's
    natural-log log-sum-exp; a row that saw no key: o = 0, lse = -inf."""
    o = (acc / torch.clamp(l[..., None], min=1e-30)).transpose(1, 2)
    lse = torch.where(torch.isfinite(m), m + torch.log(l), -math.inf)
    return o.to(dtype), lse.float()


def merge_attention_lse(o: torch.Tensor, lse: torch.Tensor, ax
                        ) -> torch.Tensor:
    """Combine per-shard attention over the axis ``ax``
    (``runtime.collectives.Axis``; the JAX package's
    ``merge_attention_stats`` in its log-sum-exp form): each member's
    normalized o (B, T, H, D) and lse (B, H, T) (``flash_verify_stats``,
    or ``stats_to_lse`` of (acc, m, l)) -> the attention over every
    member's keys, (B, T, H, D) f32. One gather carries both; every
    member sums the shards in rank order, so the result is equal to the
    bit on each. A shard with lse = -inf adds nothing; a row no shard saw
    returns 0."""
    from ..runtime.collectives import all_gather

    both = torch.cat([o.float(), lse.transpose(1, 2)[..., None]], -1)
    parts = all_gather(both, ax)                      # (n, B, T, H, D + 1)
    lses = parts[..., -1]
    top = lses.amax(0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    w = torch.where(torch.isfinite(lses), torch.exp(lses - top), 0.0)
    num = parts[0, ..., :-1] * w[0, ..., None]
    den = w[0]
    for i in range(1, parts.shape[0]):
        num = num + parts[i, ..., :-1] * w[i, ..., None]
        den = den + w[i]
    return num / torch.clamp(den[..., None], min=1e-30)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor,
                     *, window: Optional[int] = None) -> torch.Tensor:
    """Single-position attention against a cache. q: (B, 1, H, D);
    k_cache/v_cache: (B, S_max, h_kv, D); kv_len: (B,) valid entries
    (current token included) -> (B, 1, H, D)."""
    acc, m, l = decode_attention_stats(q, k_cache, v_cache, kv_len,
                                       window=window)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out[:, None].to(q.dtype)


def _dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, window: Optional[int],
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Dispatch attention over a contiguous cache (decode and verify): the
    CUDA kernel B5 for tensors on the card (unless
    ``ops.use_kernels(False)``), which reads an int8 cache with its scales
    as it is stored; otherwise ``verify_attention``, over an int8 cache
    dequantized to q's dtype first, as in the reference."""
    from ..kernels import ops
    if ops.kernels_active(q):
        return ops.flash_verify(q, k, v, kv_len.int(), window=window,
                                k_scale=k_scale, v_scale=v_scale)
    if k_scale is not None:
        k = dequantize_kv(k, k_scale, q.dtype)
        v = dequantize_kv(v, v_scale, q.dtype)
    return verify_attention(q, k, v, kv_len, window=window)


def shard_attention_stats(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, kv_len: torch.Tensor, *,
                          window: Optional[int],
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over one sequence shard of a contiguous cache, with the
    stats a merge over the shards needs: (o (B, T, H, D) in q.dtype, lse
    (B, H, T) f32). ``kv_len`` is counted from the shard's first line (the
    global length less the shard's offset: 0 or less masks every row).
    The CUDA kernel B5 with its stats for tensors on the card (unless
    ``ops.use_kernels(False)``), else ``verify_attention_stats`` (an int8
    shard dequantized to q's dtype first)."""
    from ..kernels import ops
    if ops.kernels_active(q):
        return ops.flash_verify_stats(q, k, v, kv_len.int().contiguous(),
                                      window=window, k_scale=k_scale,
                                      v_scale=v_scale)
    if k_scale is not None:
        k = dequantize_kv(k, k_scale, q.dtype)
        v = dequantize_kv(v, v_scale, q.dtype)
    acc, m, l = verify_attention_stats(q, k, v, kv_len, window=window)
    return stats_to_lse(acc, m, l, q.dtype)


# --------------------------------------------------------------------------- #
#  attention block (GQA, optional QKV bias)
# --------------------------------------------------------------------------- #

def attn_qkv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    H, hk, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = qmm(x, p.wq)
    k = qmm(x, p.wk)
    v = qmm(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, hk, hd)
    v = v.reshape(B, S, hk, hd)
    if not cfg.use_rope:
        return q, k, v
    return rotate(q, positions, cfg), rotate(k, positions, cfg), v


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: (B,S,h,d) -> int8 + f32 scale."""
    tf = t.float()
    amax = tf.abs().amax(-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127).to(
        torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype
                  ) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Bidirectional attention in f32 (whisper's encoder and cross
    attention). q: (B, Sq, H, D); k, v: (B, Sk, h_kv, D)."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.float())
    return out.to(q.dtype)


def attn_block(p, cfg: ModelConfig, x: torch.Tensor, positions,
               *, cache: Optional[Dict] = None, decode: bool = False,
               cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               causal: bool = True) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full attention block: qkv -> attention -> o-proj.

    ``cache``: {"k": (B,Smax,hk,hd), "v": ..., "len": (B,)} (+ int8
    ``k_scale``/``v_scale``). Decode writes the S new lines in place at
    ``len`` (rolling for a window-sized buffer) and attends over the
    cache through ``_dense_attention`` (an int8 cache goes with its
    scales: B5 reads it as stored, the plain path dequantizes it first, as
    in the reference); prefill runs causal attention over ``x`` (or,
    ``causal=False``, bidirectional: whisper's encoder) and fills the
    cache in place. ``cross_kv``: (k, v) of an encoder, the keys and
    values of whisper's cross attention (only q is projected; plain
    torch, as in the reference). Returns (out, cache) with the cache's
    ``len`` advanced.
    """
    B, S, _ = x.shape
    if cross_kv is not None:
        q = (x @ p.wq).reshape(B, S, cfg.n_heads, cfg.head_dim)
        if cfg.qkv_bias:
            q = q + p.bq.reshape(cfg.n_heads, cfg.head_dim)
        k, v = cross_kv
        out = chunked_causal_attention(q, k, v, chunk=256) if causal \
            else _full_attention(q, k, v)
        return out.reshape(B, S, -1) @ p.wo, cache
    q, k, v = attn_qkv(p, cfg, x, positions)
    out, new_cache = attend(cfg, q, k, v, cache=cache, decode=decode,
                            causal=causal)
    o = qmm(out.reshape(B, S, -1), p.wo)
    return o, new_cache


def attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *, cache: Optional[Dict] = None,
           decode: bool = False, causal: bool = True
           ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """``attn_block`` between its projections: q (B, S, H, hd), k and v
    (B, S, h_kv, hd), rotated -> (the attention (B, S, H, hd), the cache
    with ``len`` advanced), the cache written as ``attn_block`` says (the
    heads are the tensors', so a tensor-parallel member passes its
    own)."""
    B, S = q.shape[:2]
    window = cfg.attn_window
    quantized = cache is not None and "k_scale" in cache
    new_cache = cache
    if decode:
        if cache is None:
            raise ValueError("decode needs a cache")
        kc, vc, ln = cache["k"], cache["v"], cache["len"]
        Smax = kc.shape[1]
        rolling = window is not None and Smax == window
        if S > 1 and rolling:
            raise ValueError("multi-token decode needs Smax > window")
        if quantized:
            k_wr, ksc = quantize_kv(k)
            v_wr, vsc = quantize_kv(v)
        else:
            k_wr, v_wr = k.to(kc.dtype), v.to(vc.dtype)
        bidx = torch.arange(B, device=q.device)
        for t in range(S):                       # small (draft block)
            slot = (ln + t) % window if rolling \
                else torch.clamp(ln + t, max=Smax - 1)
            slot = slot.long()
            kc[bidx, slot] = k_wr[:, t]
            vc[bidx, slot] = v_wr[:, t]
            if quantized:
                cache["k_scale"][bidx, slot] = ksc[:, t].to(
                    cache["k_scale"].dtype)
                cache["v_scale"][bidx, slot] = vsc[:, t].to(
                    cache["v_scale"].dtype)
        new_cache = {**cache, "len": ln + S}
        kv_len = torch.clamp(ln + S, max=Smax) if window is not None \
            else ln + S
        if quantized:
            out = _dense_attention(q, kc, vc, kv_len, window=window,
                                   k_scale=cache["k_scale"],
                                   v_scale=cache["v_scale"])
        else:
            out = _dense_attention(q, kc.to(q.dtype), vc.to(q.dtype), kv_len,
                                   window=window)
    else:
        out = chunked_causal_attention(q, k, v, window=window) if causal \
            else _full_attention(q, k, v)
        if cache is not None:
            Smax = cache["k"].shape[1]
            if window is not None and Smax <= S:
                # rolling buffer: token t lives at slot t % Smax
                kk = torch.roll(k[:, -Smax:], S % Smax, dims=1)
                vv = torch.roll(v[:, -Smax:], S % Smax, dims=1)
            else:
                kk, vv = k[:, :Smax], v[:, :Smax]
            n = kk.shape[1]
            if quantized:
                kq, ksc = quantize_kv(kk)
                vq, vsc = quantize_kv(vv)
                cache["k"][:, :n] = kq
                cache["v"][:, :n] = vq
                cache["k_scale"][:, :n] = ksc.to(cache["k_scale"].dtype)
                cache["v_scale"][:, :n] = vsc.to(cache["v_scale"].dtype)
            else:
                cache["k"][:, :n] = kk.to(cache["k"].dtype)
                cache["v"][:, :n] = vv.to(cache["v"].dtype)
            new_cache = {**cache, "len": cache["len"] + S}
    return out, new_cache


# --------------------------------------------------------------------------- #
#  paged KV cache: block-table gather / scatter + paged attention
# --------------------------------------------------------------------------- #

def gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(P, bs, ...) page pool + (B, nb) block table -> (B, nb*bs, ...).

    Table entry ``j`` covers absolute positions ``j*bs .. (j+1)*bs - 1``;
    entries past a sequence's length may point anywhere valid (sink or
    stale page) — the caller masks those positions.
    """
    g = pages[table.long()]                          # (B, nb, bs, ...)
    B, nb, bs = g.shape[:3]
    return g.reshape(B, nb * bs, *g.shape[3:])


def write_pages(pages: torch.Tensor, table: torch.Tensor, ln: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """Write T new cache lines at positions ``ln .. ln+T-1`` through the
    block table, in place. pages: (P, bs, ...); vals: (B, T, ...); ln: (B,).

    Distinct live slots own distinct pages, so the write indices never
    collide except on the sink page (freed slots), whose content is never
    read unmasked. Returns ``pages``.
    """
    B, T = vals.shape[:2]
    bs, nb = pages.shape[1], table.shape[1]
    pos = ln.long()[:, None] + torch.arange(T, device=vals.device)[None]
    blk = torch.clamp(pos // bs, max=nb - 1)
    pid = table.long().gather(1, blk)
    pages[pid.reshape(-1), (pos % bs).reshape(-1)] = vals.reshape(
        B * T, *vals.shape[2:]).to(pages.dtype)
    return pages


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """Multi-position attention against a paged cache (plain version of
    the ``paged_verify`` kernel): gather through the table, then
    ``verify_attention``. q: (B, T, H, D); kv_len includes the T tokens."""
    k = gather_pages(k_pages, table)
    v = gather_pages(v_pages, table)
    return verify_attention(q, k, v, kv_len, window=window)


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, table: torch.Tensor,
                            kv_len: torch.Tensor, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """Chunk-vs-pages causal attention with the dense-prefill math
    (``chunked_causal_attention``), so a chunk-prefilled slot is
    byte-identical to one-shot dense prefill. Chunked admission runs one
    slot at a time, so every row uses ``kv_len[0]``."""
    S = q.shape[1]
    k = gather_pages(k_pages, table).to(q.dtype)
    v = gather_pages(v_pages, table).to(q.dtype)
    return chunked_causal_attention(q, k, v, window=window,
                                    q_offset=int(kv_len[0]) - S)


def _paged_attention(q: torch.Tensor, pages: Pages, table: torch.Tensor,
                     kv_len: torch.Tensor, *, window: Optional[int],
                     prefill: bool) -> torch.Tensor:
    """Dispatch paged attention: the CUDA kernel for tensors on the card
    (unless ``ops.use_kernels(False)``), the plain torch path otherwise.
    int8 pools go through the fused-dequant kernel for decode and chunked
    admission alike, as in the reference: chunk row t sits at
    ``kv_len - S + t``, which is the prefill geometry at B = 1."""
    from ..kernels import ops
    if ops.kernels_active(q):
        if "k_scale" in pages:
            return ops.paged_verify_quant(
                q, pages["k"], pages["v"], pages["k_scale"],
                pages["v_scale"], table, kv_len, window=window)
        kern = ops.paged_prefill if prefill else ops.paged_verify
        return kern(q, pages["k"], pages["v"], table, kv_len, window=window)
    if "k_scale" in pages:
        k = dequantize_kv(gather_pages(pages["k"], table),
                          gather_pages(pages["k_scale"], table), q.dtype)
        v = dequantize_kv(gather_pages(pages["v"], table),
                          gather_pages(pages["v_scale"], table), q.dtype)
        if prefill:
            S = q.shape[1]
            return chunked_causal_attention(q, k, v, window=window,
                                            q_offset=int(kv_len[0]) - S)
        return verify_attention(q, k, v, kv_len, window=window)
    if prefill:
        return paged_prefill_attention(q, pages["k"], pages["v"], table,
                                       kv_len, window=window)
    return paged_verify_attention(q, pages["k"], pages["v"], table, kv_len,
                                  window=window)


def attn_block_paged(p, cfg: ModelConfig, x: torch.Tensor, positions,
                     pages: Pages, table: torch.Tensor, ln: torch.Tensor,
                     *, prefill: bool = False, write: bool = True
                     ) -> torch.Tensor:
    """Attention block over one layer's page pool.

    ``pages``: {"k": (P, bs, h_kv, hd), "v": ...} plus ``k_scale``/
    ``v_scale`` (P, bs, h_kv) for int8 pools (new lines quantize on
    write). ``ln``: (B,) valid lengths BEFORE this step. Writes the S new
    lines through the table in place, then attends. ``prefill``: chunked
    admission (dense-prefill math); ``write=False`` skips the writes (a
    fully prefix-shared prompt re-derives its last logits read-only).
    """
    B, S, _ = x.shape
    q, k, v = attn_qkv(p, cfg, x, positions)
    if write:
        if "k_scale" in pages:
            kq, ksc = quantize_kv(k)
            vq, vsc = quantize_kv(v)
            write_pages(pages["k"], table, ln, kq)
            write_pages(pages["v"], table, ln, vq)
            write_pages(pages["k_scale"], table, ln, ksc)
            write_pages(pages["v_scale"], table, ln, vsc)
        else:
            write_pages(pages["k"], table, ln, k)
            write_pages(pages["v"], table, ln, v)
    out = _paged_attention(q, pages, table, ln + S,
                           window=cfg.attn_window, prefill=prefill)
    return qmm(out.reshape(B, S, -1), p.wo)


# --------------------------------------------------------------------------- #
#  MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# --------------------------------------------------------------------------- #

def mla_project(p, cfg: ModelConfig, x: torch.Tensor, positions
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """MLA's projections: (q_nope (B, S, H, dn), q_rope (B, S, H, dr)
    rotated, the normed latent (B, S, r_kv), the cache line (B, S, r_kv +
    dr): latent and rotated key rope). Through ``qmm``: a ring bank may
    keep ``wq_a``, ``wq_b`` and ``wkv_a`` packed (the layer-wise path
    dequantizes them when it pulls the layer)."""
    B, S, _ = x.shape
    H, r_kv = cfg.n_heads, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_lat = rms_norm(qmm(x, p.wq_a), p.q_norm, cfg.norm_eps)
    q = qmm(q_lat, p.wq_b).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions,
                                             cfg.rope_theta)
    kv = qmm(x, p.wkv_a)                                  # (B, S, r_kv + dr)
    latent = rms_norm(kv[..., :r_kv], p.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, r_kv:], positions,
                        cfg.rope_theta)[:, :, 0]          # (B, S, dr)
    return q_nope, q_rope, latent, torch.cat([latent, k_rope], -1)


def _mla_scores(p, cfg: ModelConfig, q_nope: torch.Tensor,
                q_rope: torch.Tensor, lines: torch.Tensor, dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The absorbed form's scores: W_UK folded into the query, so the
    scores are taken in latent space against the cache lines (B, S_kv,
    r_kv + dr). Returns (scores (B, H, S, S_kv) f32, scaled, unmasked;
    the latents (B, S_kv, r_kv) in ``dtype``). The two score products
    run in f32, where the reference asks for f32 results of its bf16
    inputs (a bf16 product here would round them)."""
    H, r_kv, dn = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_dim
    lat_all = lines[..., :r_kv].to(dtype)
    rope_all = lines[..., r_kv:].to(dtype)
    q_abs = _einsum("bshd,rhd->bshr", q_nope, p.wk_b.reshape(r_kv, H, dn))
    s_nope = torch.einsum("bqhr,bsr->bhqs", q_abs.float(), lat_all.float())
    s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope.float(), rope_all.float())
    scale = 1.0 / math.sqrt(dn + cfg.qk_rope_dim)
    return (s_nope + s_rope) * scale, lat_all


def _mla_absorbed(p, cfg: ModelConfig, q_nope, q_rope, lines: torch.Tensor,
                  ln: torch.Tensor, dtype) -> torch.Tensor:
    """Attention of the S queries at ``ln + t`` over the cache lines
    (B, S_kv, r_kv + dr) at positions 0..S_kv-1, causal (position <= the
    query's). -> (B, S, H * dv)."""
    S, S_kv = q_nope.shape[1], lines.shape[1]
    s_all, lat_all = _mla_scores(p, cfg, q_nope, q_rope, lines, dtype)
    dev = lines.device
    qpos = ln.long()[:, None] + torch.arange(S, device=dev)[None]  # (B, S)
    mask = torch.arange(S_kv, device=dev)[None, None] <= qpos[..., None]
    pr = torch.softmax(s_all.masked_fill(~mask[:, None], -math.inf), -1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", pr, lat_all.float())
    B, S, H, r_kv = o_lat.shape
    wv = p.wv_b.reshape(r_kv, H, cfg.v_head_dim)        # W_UV
    return _einsum("bqhr,rhv->bqhv", o_lat.to(dtype), wv).reshape(B, S, -1)


def mla_prefill_attention(p, cfg: ModelConfig, q_nope, q_rope, latent,
                          lat_cat) -> torch.Tensor:
    """MLA's causal attention over a prompt (``mla_project``'s outputs):
    the latent expanded to per-head K and V (V zero-padded to dn + dr
    for the chunked attention, then sliced). -> (B, S, H * dv)."""
    B, S = latent.shape[:2]
    H, r_kv = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    k_nope = _einsum("bsr,rhd->bshd", latent, p.wk_b.reshape(r_kv, H, dn))
    vv = _einsum("bsr,rhv->bshv", latent, p.wv_b.reshape(r_kv, H, dv))
    kk = torch.cat([k_nope, lat_cat[:, :, None, r_kv:].expand(
        B, S, H, dr).to(k_nope.dtype)], -1)
    qq = torch.cat([q_nope, q_rope], -1)
    v_p = torch.nn.functional.pad(vv, (0, dn + dr - dv))
    return chunked_causal_attention(qq, kk, v_p)[..., :dv].reshape(
        B, S, H * dv)


def mla_block(p, cfg: ModelConfig, x: torch.Tensor, positions, *,
              cache: Optional[Dict] = None, decode: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA attention over a dense latent cache ({"latent": (B, Smax, r_kv
    + dr), "len"}, written in place). Prefill expands the latent to
    per-head K and V (V zero-padded to dn + dr for the chunked attention,
    then sliced) and writes the cache lines; decode (T >= 1, causal among
    its tokens) takes the absorbed form over the cache. Plain torch on
    every device, as the reference computes it outside any kernel."""
    B, S, _ = x.shape
    H, r_kv = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope, latent, lat_cat = mla_project(p, cfg, x, positions)
    new_cache = cache
    if decode:
        if cache is None:
            raise ValueError("decode needs a cache")
        lc, ln = cache["latent"], cache["len"]
        bidx = torch.arange(B, device=x.device)
        for t in range(S):                       # small (draft block)
            slot = torch.clamp(ln + t, max=lc.shape[1] - 1).long()
            lc[bidx, slot] = lat_cat[:, t].to(lc.dtype)
        new_cache = {**cache, "len": ln + S}
        out = _mla_absorbed(p, cfg, q_nope, q_rope, lc, ln, x.dtype)
    else:
        out = mla_prefill_attention(p, cfg, q_nope, q_rope, latent, lat_cat)
        if cache is not None:
            n = min(S, cache["latent"].shape[1])
            cache["latent"][:, :n] = lat_cat[:, :n].to(cache["latent"].dtype)
            new_cache = {**cache, "len": cache["len"] + S}
    return qmm(out, p.wo), new_cache


def mla_block_paged(p, cfg: ModelConfig, x: torch.Tensor, positions,
                    pages: Pages, table: torch.Tensor, ln: torch.Tensor,
                    *, write: bool = True) -> torch.Tensor:
    """MLA over paged latent storage ({"latent": (P, bs, r_kv + dr)}):
    ``mla_block``'s absorbed decode with the lines gathered through the
    block table. Its masking is already chunk-causal, so chunked
    admission takes this path too; ``write=False`` skips the line writes
    (a fully prefix-shared prompt)."""
    q_nope, q_rope, _, lat_cat = mla_project(p, cfg, x, positions)
    if write:
        write_pages(pages["latent"], table, ln, lat_cat)
    lines = gather_pages(pages["latent"], table)
    out = _mla_absorbed(p, cfg, q_nope, q_rope, lines, ln, x.dtype)
    return qmm(out, p.wo)


# --------------------------------------------------------------------------- #
#  FFN
# --------------------------------------------------------------------------- #

def _tp_sum(y: torch.Tensor, tp) -> torch.Tensor:
    """The sum over a tensor-parallel axis after a split down projection
    (``tp`` None: no split); under autograd the gradient passes as it is
    (``collectives.tp_sum``)."""
    if tp is None:
        return y
    from ..runtime.collectives import tp_sum
    return tp_sum(y, tp)


def _tp_enter(x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` entering a member's part of a split product: under autograd
    its gradient sums over ``tp`` (``collectives.tp_enter``)."""
    if tp is None:
        return x
    from ..runtime.collectives import tp_enter
    return tp_enter(x, tp)


def glu_ffn(p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The GLU FFN; ``tp`` (a ``runtime.collectives.Axis``): ``p`` holds
    this member's slice of d_ff, and the down projections sum over it."""
    x = _tp_enter(x, tp)
    return _tp_sum(qmm(swish(qmm(x, p.w_gate)) * qmm(x, p.w_up), p.w_down),
                   tp)


#: tokens a dispatch takes at once; a longer step splits into chunks, each
#: with its own capacity (the JAX package's bound on the (E, C, d) buffer)
MOE_MAX_CHUNK = 65_536


def expert_mm(x: torch.Tensor, w) -> torch.Tensor:
    """Every expert's product: x (E, C, K) by w (E, K, N), in x.dtype.

    A packed q4 stack (E, K/2, N) on the card goes to kernel B3 one
    expert's 2-D slice at a time, at M = C rows: E launches, every expert
    whether or not a token was routed to it, so the shapes are fixed and a
    decode step stays graphable. That is the same function as the JAX
    package's, which dequantizes the stack to f32 and multiplies (B3
    dequantizes tile by tile in f32 and accumulates in f32), without
    writing the dequantized stack: mixtral-8x7b's three stacks are 5.6 GB
    a layer in f32. Elsewhere a quantized stack dequantizes at use, as
    ``qmm`` does, and a plain stack is one batched product.
    """
    if isinstance(w, QuantizedTensor):
        from ..kernels import ops

        if w.bits == 4 and ops.kernels_active(x):
            out = [ops.q4_matmul(x[e].contiguous(), w.packed[e], w.scale[e],
                                 group=w.group)
                   for e in range(x.shape[0])]
            return torch.stack(out).to(x.dtype)
        return x @ dequantize_leaf(w, torch.float32).to(x.dtype)
    return _matmul(x, w).to(x.dtype)


def moe_route(router, cfg: ModelConfig, xt: torch.Tensor, *,
              lossless: bool) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The JAX package's routing of ``xt`` (T, d): f32 router logits,
    softmax, top-k (ties to the lower expert, as ``lax.top_k``), gates
    normalised by max(sum, 1e-9); then each routed row's place in its
    expert's capacity bucket from the cumulative count over the flattened
    (T*K) routing, token-major then k. Returns (gates (T, K), slot (T*K,)
    in [0, E*C], E*C for a row over capacity, C)."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = _matmul(xt, router).float()                      # (T, E)
    probs, idx = torch.softmax(logits, -1).sort(dim=-1, descending=True,
                                                stable=True)
    gates, idx = probs[:, :K], idx[:, :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    cf = cfg.moe_capacity_factor
    if lossless or cf is None:
        C = T
    else:
        C = min(max(int(K * T / E * cf), 1), T)
    flat_e = idx.reshape(-1)                                  # (T*K,)
    oh = (flat_e[:, None] == torch.arange(E, device=xt.device)).long()
    pos_in_e = (oh.cumsum(0) * oh).sum(-1) - 1
    slot = torch.where(pos_in_e < C, flat_e * C + pos_in_e,
                       torch.full_like(flat_e, E * C))
    return gates, slot, C


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor, *,
            lossless: bool = False, tp=None, ep: bool = False
            ) -> torch.Tensor:
    """Top-k MoE with capacity-bounded dispatch (``repro.models.layers.
    moe_ffn``): routed rows scatter into one (E*C + 1, d) buffer (rows
    over capacity to the pad row E*C, which nothing reads), the experts
    run over (E, C, d) (``expert_mm``), and the outputs gather back
    weighted by the gates. ``lossless`` (or ``cfg.moe_capacity_factor``
    None) sets C = T, so no row is dropped. Every shape is fixed by x's, and
    nothing reads a value back to the host, so a step stays graphable.
    ``tp`` (a ``runtime.collectives.Axis``): every expert's d_ff is split
    over it (TP inside each expert, as the JAX ring runs it) and the
    combined output sums over it; with ``ep`` the experts are split
    instead (expert parallelism: ``p``'s stacks hold this member's E/tp
    experts, the others' rows stay zero here). The routing is repeated
    on every member; under autograd the dispatched rows and the gates
    enter the member's part through ``collectives.tp_enter``."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    n_chunks = max(-(-(B * S) // MOE_MAX_CHUNK), 1)
    if S % n_chunks == 0 and n_chunks > 1:
        xs = x.reshape(B, n_chunks, S // n_chunks, d).transpose(0, 1)
        out = torch.stack([moe_ffn(p, cfg, xc, lossless=lossless, tp=tp,
                                   ep=ep)
                           for xc in xs])
        return out.transpose(0, 1).reshape(B, S, d)
    xt = x.reshape(B * S, d)
    gates, slot, C = moe_route(p.router, cfg, xt, lossless=lossless)
    gates = _tp_enter(gates, tp)
    buf = x.new_zeros((E * C + 1, d))
    buf.index_copy_(0, slot, _tp_enter(xt, tp).repeat_interleave(K, 0))
    xe = buf[:E * C].reshape(E, C, d)
    if ep and tp is not None:
        n = E // tp.size
        xe = xe[tp.index * n:(tp.index + 1) * n]
    h = swish(expert_mm(xe, p.w_gate)) * expert_mm(xe, p.w_up)
    ye = expert_mm(h, p.w_down)
    if ep and tp is not None:
        # the member's experts' rows; the others' (and the pad row) zero
        ye_flat = ye.new_zeros((E * C + 1, d))
        ye_flat[tp.index * n * C:(tp.index + 1) * n * C] = \
            ye.reshape(n * C, d)
    else:
        ye_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    y = (ye_flat[slot].reshape(B * S, K, d)
         * gates.to(ye.dtype)[..., None]).sum(1)
    return _tp_sum(y.reshape(B, S, d), tp)


def block_ffn(p, cfg: ModelConfig, x: torch.Tensor, *,
              lossless: bool, tp=None, ep: bool = False) -> torch.Tensor:
    """A dense block's FFN: ``moe_ffn`` over ``p.moe`` for the moe family,
    else ``glu_ffn`` over ``p.ffn`` (``tp``: split over that axis; ``ep``:
    the experts split over it)."""
    if cfg.n_experts:
        return moe_ffn(p.moe, cfg, x, lossless=lossless, tp=tp, ep=ep)
    return glu_ffn(p.ffn, x, tp)


# --------------------------------------------------------------------------- #
#  RG-LRU recurrent block (RecurrentGemma / Griffin)
# --------------------------------------------------------------------------- #

def doubling_scan(a: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 from h = 0:
    returns (the products of a up to t, h_t), the pair
    ``lax.associative_scan`` gives for the combine (al ar, bl ar + br).
    log2(S) doubling steps of whole-tensor ops (Hillis-Steele), not a loop
    over the tokens; its sums associate in another order than the JAX
    tree's, so the two agree to rounding."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1)
        d *= 2
    return a, b


def rglru_block(p, cfg: ModelConfig, x: torch.Tensor, *,
                cache: Optional[Dict] = None, decode: bool = False
                ) -> torch.Tensor:
    """Griffin recurrent block: a gating branch, a causal conv, then the
    RG-LRU gated linear recurrence. cache: {"h": (B, w), "conv": (B, K-1,
    w)}, written in place. Prefill scans with ``doubling_scan`` from the
    cache's state; decode (S = 1) is the one-step update. Plain torch, as
    in the reference."""
    B, S, _ = x.shape
    branch_y = swish(x @ p.w_y)
    u, new_conv = _causal_conv1d(x @ p.w_x, p.conv_w,
                                 None if cache is None else cache["conv"])
    i_gate = torch.sigmoid(u * p.gate_i)
    r_gate = torch.sigmoid(u * p.gate_r)
    log_a = -8.0 * r_gate * torch.nn.functional.softplus(getattr(p, "lambda"))
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (u * i_gate)
    h0 = cache["h"].to(a.dtype) if cache is not None else a.new_zeros(
        (B, a.shape[-1]))
    if decode:
        if S != 1:
            raise ValueError("RG-LRU decode takes one token a sequence")
        y_seq = (a[:, 0] * h0 + b[:, 0])[:, None]
    else:
        a_s, b_s = doubling_scan(a, b)
        y_seq = a_s * h0[:, None] + b_s
    if cache is not None:
        cache["h"].copy_(y_seq[:, -1])
        cache["conv"].copy_(new_conv)
    return (y_seq.to(x.dtype) * branch_y) @ p.w_out


# --------------------------------------------------------------------------- #
#  Mamba-2 SSD block
# --------------------------------------------------------------------------- #

def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C), w: (K, C).

    Returns (y, new_state) where state is the trailing K-1 inputs.
    """
    K = w.shape[0]
    B, S, C = x.shape
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (B, S+K-1, C)
    w = w.to(x.dtype)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    new_state = xp[:, S:] if K > 1 else xp[:, :0]
    return y, new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor,
                h0: Optional[torch.Tensor] = None, chunk: int = 128
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """State-space-duality chunked scan (Mamba-2 alg. 1), plain torch.

    x: (B, S, nh, P); dt: (B, S, nh); A: (nh,) <= 0; Bmat/Cmat: (B, S, N);
    h0: (B, nh, P, N) or None (the zero state). Returns (y (B, S, nh, P),
    h_final (B, nh, P, N)), both in x.dtype. S is zero-padded to a multiple
    of ``chunk`` (padded positions have dt = 0, so they move nothing).
    Every product and sum is in f32, as in the TPU kernel B6; the JAX
    function keeps C.B in the inputs' dtype, which only bf16 inputs see.
    The reference's dt-weighted ``GB`` product is dead code there and is
    not formed here: it would be a (B, nc, chunk, nh, P, N) f32 tensor.
    """
    Bsz, S, nh, P = x.shape
    N = Bmat.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    f = torch.nn.functional.pad
    xr = f(x.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, chunk, nh, P)
    dtr = f(dt.float(), (0, 0, 0, pad)).reshape(Bsz, nc, chunk, nh)
    Br = f(Bmat.float(), (0, 0, 0, pad)).reshape(Bsz, nc, chunk, N)
    Cr = f(Cmat.float(), (0, 0, 0, pad)).reshape(Bsz, nc, chunk, N)
    cum = torch.cumsum(dtr * A.float(), dim=2)             # (B, nc, c, nh)
    seg_total = cum[:, :, -1]                               # (B, nc, nh)

    # intra-chunk: L[t, s] = exp(cum[t] - cum[s]) for t >= s; the masked
    # (t < s) differences are positive and overflow, so they become -inf
    # BEFORE exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,t,s,nh)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    Lmat = torch.exp(diff.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))
    scores = torch.einsum("bctn,bcsn->bcts", Cr, Br)
    w = scores[..., None] * Lmat * dtr[:, :, None, :, :]    # (B,nc,t,s,nh)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", w, xr)

    # inter-chunk: chunk state sum_s exp(cum_end - cum_s) dt_s x_s B_s^T
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)
    chunk_state = torch.einsum("bcshp,bcsn->bchpn",
                               xr * (decay_to_end * dtr)[..., None], Br)
    h = torch.zeros((Bsz, nh, P, N), dtype=torch.float32,
                    device=x.device) if h0 is None else h0.float()
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(seg_total[:, c])[:, :, None, None] \
            + chunk_state[:, c]
    h_prev = torch.stack(h_prev, dim=1)                     # (B,nc,nh,P,N)
    y_inter = torch.einsum("bctn,bchpn->bcthp", Cr, h_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, nc * chunk, nh, P)[:, :S]
    return y.to(x.dtype), h.to(x.dtype)


def ssd_block(p, cfg: ModelConfig, x: torch.Tensor, *,
              cache: Optional[Dict] = None, decode: bool = False,
              fresh: bool = False) -> torch.Tensor:
    """Mamba-2 block: in-proj -> conv -> SSD -> gated norm -> out-proj.

    cache: {"conv": (B, K-1, di+2N), "state": (B, nh, P, N)}, written in
    place. A prefill from the zero state (no cache, or ``fresh``: the
    caller knows the cache is ``init_cache``'s) runs the scan through
    ``ops.ssd_scan`` (kernel B6 on the card); a prefill that continues the
    cache's state takes ``ssd_chunked`` with ``h0``; decode (S = 1) is the
    recurrence's one step in f32.
    """
    return qmm(ssd_mix(p, cfg, qmm(x, p.in_proj), cache=cache,
                       decode=decode, fresh=fresh, dtype=x.dtype),
               p.out_proj)


def ssd_mix(p, cfg: ModelConfig, zxbcdt: torch.Tensor, *,
            cache: Optional[Dict] = None, decode: bool = False,
            fresh: bool = False, dtype=None) -> torch.Tensor:
    """``ssd_block`` between its two projections: the in-projection's
    output (B, S, 2di + 2N + nh) -> the gated, normed SSD output (B, S,
    di) (``dtype``: the block input's, which the output and the state
    take; the projection's by default)."""
    from ..kernels import ops

    B, S, _ = zxbcdt.shape
    dtype = dtype or zxbcdt.dtype
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // P
    z, xbc, dt = zxbcdt.split([di, di + 2 * N, nh], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv1d(xbc, p.conv_w, conv_state)
    xbc = swish(xbc)
    xs, Bmat, Cmat = xbc.split([di, N, N], dim=-1)
    dt = torch.nn.functional.softplus(dt.float() + p.dt_bias.float())
    A = -torch.exp(p.a_log.float())                         # (nh,)
    xh = xs.reshape(B, S, nh, P)                            # a strided view

    if decode:
        assert S == 1 and cache is not None
        dA = torch.exp(dt[:, 0] * A[None])                  # (B, nh)
        dBx = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0].float(),
                           Bmat[:, 0].float())
        h = cache["state"].float() * dA[:, :, None, None] + dBx
        y = torch.einsum("bn,bhpn->bhp", Cmat[:, 0].float(), h)
        y = y[:, None].to(dtype)
        h_fin = h.to(dtype)
    elif cache is None or fresh:
        y, h_fin = ops.ssd_scan(xh, dt, A, Bmat, Cmat)
    else:
        y, h_fin = ssd_chunked(xh, dt, A, Bmat, Cmat, h0=cache["state"])
    y = y + xh * p.d_skip.to(dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rms_norm(y * swish(z), p.norm, cfg.norm_eps)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(h_fin)
    return y
