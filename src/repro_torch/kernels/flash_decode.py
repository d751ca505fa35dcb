"""Decode/verify attention over a contiguous KV cache: the CUDA kernel B5
and its plain torch versions.

Counterpart of ``repro/kernels/flash_decode.py`` (Pallas). The kernel lives
in ``csrc/flash_decode.cu``; the wrapper checks what it is given, allocates
the output and launches on the current stream without synchronising. It
takes CUDA tensors only — ``kernels.ops`` routes CPU tensors to the plain
versions beside it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .paged_decode import SMEM_LIMIT, _code, _window

_FLOATS = (torch.float32, torch.bfloat16)


def flash_verify(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """B5. q: (B, T, H, D) f32/bf16; k/v: (B, S, h_kv, D) f32/bf16 (either
    dtype, whatever q's) in the cache's stored layout, read through their
    strides; kv_len: (B,) int32 valid positions *including* the T query
    tokens (it may exceed S) -> (B, T, H, D) in q.dtype. Row t sits at
    ``kv_len - T + t`` and sees the positions < S at or before its own."""
    name = "flash_verify"
    for t in (q, k, v, kv_len):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device (got {t.device}, q on {q.device})")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q must be (B, T, H, D) and k/v "
                         f"(B, S, h_kv, D)")
    B, T, H, D = q.shape
    Bk, S, h_kv, Dk = k.shape
    if Bk != B or Dk != D or v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v must share strides")
    if H % h_kv:
        raise ValueError(f"{name}: {H} heads not a multiple of {h_kv}")
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError(f"{name}: q and k/v need a contiguous last dim")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,) \
            or not kv_len.is_contiguous():
        raise TypeError(f"{name}: kv_len must be contiguous (B,) int32")
    if B == 0 or T == 0 or S == 0:
        raise ValueError(f"{name}: empty batch, query block or cache")
    qc = _code(q, _FLOATS, f"{name} q")
    kc = _code(k, _FLOATS, f"{name} k/v")
    lib = _build.load("flash_decode")
    smem = lib.flash_decode_smem_bytes(T, H, h_kv, D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} B of shared memory per CTA "
                         f"(D={D}); limit {SMEM_LIMIT}")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    code = lib.flash_verify(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), qc, kc, B, T, H, h_kv, D, S, _window(window),
        1.0 / math.sqrt(D), *q.stride()[:3], *k.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, name, "flash_decode")
    _build.LAUNCHES[name] += 1
    return out


def flash_decode(q, k, v, kv_len, *, window: Optional[int] = None
                 ) -> torch.Tensor:
    """q: (B, H, D) -> (B, H, D): the T = 1 slice of ``flash_verify``."""
    return flash_verify(q[:, None], k, v, kv_len, window=window)[:, 0]


# --------------------------------------------------------------------------- #
#  plain versions
# --------------------------------------------------------------------------- #

def flash_verify_ref(q, k, v, kv_len, *, window: Optional[int] = None
                     ) -> torch.Tensor:
    """Plain B5: the model layer's ``verify_attention``."""
    from ..models.layers import verify_attention
    return verify_attention(q, k, v, kv_len, window=window)


def flash_decode_ref(q, k, v, kv_len, *, window: Optional[int] = None
                     ) -> torch.Tensor:
    """Plain B5 at T = 1: the model layer's ``decode_attention``."""
    from ..models.layers import decode_attention
    return decode_attention(q[:, None], k, v, kv_len, window=window)[:, 0]
