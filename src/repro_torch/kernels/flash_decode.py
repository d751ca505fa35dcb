"""Decode/verify attention over a contiguous KV cache: the CUDA kernel B5
and its plain torch versions.

Counterpart of ``repro/kernels/flash_decode.py`` (Pallas). The kernel is
design 2 of ``csrc/paged_tiles.cu`` (see ``paged_decode.py``) in its
contiguous addressing mode: the cache's lines are the keys, read in place
through the cache's strides, split across CTAs in runs of 256 and merged
in split order. An int8 cache is read as int8 with its scales and widened
inside the kernel, as B4 reads int8 pages: the model's dequantized copy of
the cache is never made. ``flash_verify_stats`` is the same launch with
each row's log-sum-exp written beside its output (the ring's sequence-split
merge takes both). The wrapper checks what it is given, allocates
the output and launches on the current stream without synchronising. It
takes CUDA tensors only -- ``kernels.ops`` routes CPU tensors to the plain
versions beside it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .paged_decode import _dequant_pages, _launch_tiles


def flash_verify(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *, window: Optional[int] = None,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B5. q: (B, T, H, D) f32/bf16; k/v: (B, S, h_kv, D) f32/bf16 (either
    dtype, whatever q's), or int8 with ``k_scale``/``v_scale`` (B, S, h_kv)
    f32/bf16, in the cache's stored layout, read through their strides;
    kv_len: (B,) int32 valid positions *including* the T query tokens (it
    may exceed S) -> (B, T, H, D) in q.dtype. Row t sits at
    ``kv_len - T + t`` and sees the positions < S at or before its own;
    a row that sees none returns 0. Row t of a T-row call equals a T = 1
    call at its position to the bit."""
    return _launch_tiles("flash_verify", q, k, v, None, kv_len, window,
                         k_scale, v_scale)


def flash_verify_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor, *,
                       window: Optional[int] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5 with its stats: ``flash_verify``'s output and each row's
    natural-log log-sum-exp of its scaled scores, lse (B, H, T) f32, from
    the same launch (the split merge writes it). What one shard of a
    sequence-split cache gives the merge over a tensor-parallel group
    (``layers.merge_attention_lse``): a shard whose lines start at
    position ``s_start`` is called with ``kv_len - s_start``, which may be
    0 or less (every row masked) or above S. A row that sees no key has
    lse = -inf and o = 0."""
    return _launch_tiles("flash_verify_stats", q, k, v, None, kv_len, window,
                         k_scale, v_scale, stats=True)


def flash_decode(q, k, v, kv_len, *, window: Optional[int] = None,
                 k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B, H, D) -> (B, H, D): the T = 1 slice of ``flash_verify``."""
    return flash_verify(q[:, None], k, v, kv_len, window=window,
                        k_scale=k_scale, v_scale=v_scale)[:, 0]


# --------------------------------------------------------------------------- #
#  plain versions
# --------------------------------------------------------------------------- #

def _dequant(k, k_scale):
    """An int8 cache and its scales -> f32 lines; a float cache as it is."""
    return k if k_scale is None else _dequant_pages(k, k_scale)


def flash_verify_ref(q, k, v, kv_len, *, window: Optional[int] = None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain B5: the model layer's ``verify_attention`` (an int8 cache
    inflated to f32 first, as ``paged_verify_quant_ref``)."""
    from ..models.layers import verify_attention
    return verify_attention(q, _dequant(k, k_scale), _dequant(v, v_scale),
                            kv_len, window=window)


def flash_decode_ref(q, k, v, kv_len, *, window: Optional[int] = None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain B5 at T = 1: the model layer's ``decode_attention``."""
    from ..models.layers import decode_attention
    return decode_attention(q[:, None], _dequant(k, k_scale),
                            _dequant(v, v_scale), kv_len,
                            window=window)[:, 0]


def flash_verify_stats_ref(q, k, v, kv_len, *, window: Optional[int] = None,
                           k_scale=None, v_scale=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain B5 with its stats: (o (B, T, H, D) in q.dtype, lse (B, H, T)
    f32) from the model layer's ``verify_attention_stats`` (an int8 cache
    inflated to f32 first)."""
    from ..models.layers import stats_to_lse, verify_attention_stats
    acc, m, l = verify_attention_stats(q, _dequant(k, k_scale),
                                       _dequant(v, v_scale), kv_len,
                                       window=window)
    return stats_to_lse(acc, m, l, q.dtype)
