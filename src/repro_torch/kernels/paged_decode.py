"""Paged decode/verify attention: the CUDA kernels B1 (float pages) and B4
(int8 pages) and their plain torch versions.

Counterpart of ``repro/kernels/paged_decode.py`` (Pallas). The kernels live
in ``csrc/paged_attention.cu``; these wrappers check what they are given,
allocate the output and launch on the current stream without
synchronising. They take CUDA tensors only — ``kernels.ops`` routes CPU
tensors to the plain versions beside them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: dynamic shared memory a CTA may use on Hopper (227 KB)
SMEM_LIMIT = 232_448


def _code(t: torch.Tensor, allowed, what: str) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        f"(expected one of {allowed})")
    return _CODES[t.dtype]


def _check_common(q, k_pages, v_pages, table, kv_len, name: str):
    """Validate the shared geometry; returns (B, T, H, h_kv, D, bs, nb)."""
    for t in (q, k_pages, v_pages, table, kv_len):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device (got {t.device}, q on {q.device})")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"{name}: q must be (B, T, H, D) and pages "
                         f"(P, bs, h_kv, D)")
    B, T, H, D = q.shape
    P, bs, h_kv, Dk = k_pages.shape
    if Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match D={D}")
    if k_pages.stride() != v_pages.stride():
        raise ValueError(f"{name}: k and v pages must share strides")
    if H % h_kv:
        raise ValueError(f"{name}: {H} heads not a multiple of {h_kv}")
    if q.stride(-1) != 1 or k_pages.stride(-1) != 1:
        raise ValueError(f"{name}: q and pages need a contiguous last dim")
    if table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError(f"{name}: table and kv_len must be int32")
    if table.dim() != 2 or table.shape[0] != B or not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous (B, nb)")
    if kv_len.shape != (B,) or not kv_len.is_contiguous():
        raise ValueError(f"{name}: kv_len must be contiguous (B,)")
    if B == 0 or T == 0:
        raise ValueError(f"{name}: empty batch or query block")
    lib = _build.load("paged_attention")
    smem = lib.paged_attention_smem_bytes(T, H, h_kv, D, bs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} B of shared memory per "
                         f"CTA (page of {bs} tokens x D={D}); limit "
                         f"{SMEM_LIMIT}")
    return B, T, H, h_kv, D, bs, table.shape[1]


def _window(window: Optional[int]) -> int:
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    return -1 if window is None else int(window)


def _launch_float(fn_name: str, q, k_pages, v_pages, table, kv_len,
                  window: Optional[int]) -> torch.Tensor:
    B, T, H, h_kv, D, bs, nb = _check_common(q, k_pages, v_pages, table,
                                             kv_len, fn_name)
    floats = (torch.float32, torch.bfloat16)
    qc = _code(q, floats, f"{fn_name} q")
    kc = _code(k_pages, floats, f"{fn_name} pages")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lib = _build.load("paged_attention")
    code = getattr(lib, fn_name)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), qc, kc,
        B, T, H, h_kv, D, bs, nb, _window(window), 1.0 / math.sqrt(D),
        *q.stride()[:3], *k_pages.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, fn_name, "paged_attention")
    _build.LAUNCHES[fn_name] += 1
    return out


def paged_verify(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, table: torch.Tensor,
                 kv_len: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """B1. q: (B, T, H, D) f32/bf16; k_pages/v_pages: (P, bs, h_kv, D)
    f32/bf16 in their stored layout; table: (B, nb) int32; kv_len: (B,)
    int32 valid positions *including* the T query tokens -> (B, T, H, D)
    in q.dtype. Table entries past ``ceil(kv_len/bs)`` are never read."""
    return _launch_float("paged_verify", q, k_pages, v_pages, table, kv_len,
                         window)


def paged_decode(q, k_pages, v_pages, table, kv_len, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, D) -> (B, H, D): the T = 1 slice of ``paged_verify``."""
    return paged_verify(q[:, None], k_pages, v_pages, table, kv_len,
                        window=window)[:, 0]


def paged_verify_quant(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, table: torch.Tensor,
                       kv_len: torch.Tensor, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """B4. ``paged_verify`` over int8 pages (P, bs, h_kv, D) with
    per-(position, kv-head) scales (P, bs, h_kv) stored in the pool dtype
    (f32 or bf16); dequantization happens inside the kernel."""
    name = "paged_verify_quant"
    B, T, H, h_kv, D, bs, nb = _check_common(q, k_pages, v_pages, table,
                                             kv_len, name)
    qc = _code(q, (torch.float32, torch.bfloat16), f"{name} q")
    _code(k_pages, (torch.int8,), f"{name} pages")
    sc = _code(k_scale, (torch.float32, torch.bfloat16), f"{name} scales")
    if k_scale.shape != k_pages.shape[:3] or v_scale.shape != k_scale.shape \
            or v_scale.dtype != k_scale.dtype \
            or k_scale.stride() != v_scale.stride():
        raise ValueError(f"{name}: scales must be matching (P, bs, h_kv)")
    for t in (k_scale, v_scale):
        if t.device != q.device:
            raise ValueError(f"{name}: scales on {t.device}, q on "
                             f"{q.device}")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lib = _build.load("paged_attention")
    code = lib.paged_verify_quant(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), table.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), qc, sc, B, T, H, h_kv, D, bs, nb,
        _window(window), 1.0 / math.sqrt(D), *q.stride()[:3],
        *k_pages.stride()[:3], *k_scale.stride(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, name, "paged_attention")
    _build.LAUNCHES[name] += 1
    return out


def paged_decode_quant(q, k_pages, v_pages, k_scale, v_scale, table, kv_len,
                       *, window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, D) -> (B, H, D): the T = 1 slice of
    ``paged_verify_quant``."""
    return paged_verify_quant(q[:, None], k_pages, v_pages, k_scale,
                              v_scale, table, kv_len, window=window)[:, 0]


# --------------------------------------------------------------------------- #
#  plain versions
# --------------------------------------------------------------------------- #

def paged_verify_ref(q, k_pages, v_pages, table, kv_len, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Plain B1: gather the pages through the table, then
    ``verify_attention``."""
    from ..models.layers import paged_verify_attention
    return paged_verify_attention(q, k_pages, v_pages, table, kv_len,
                                  window=window)


def _dequant_pages(pages: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(P, bs, h_kv, D) int8 + (P, bs, h_kv) scales -> f32 pages."""
    return pages.float() * scale.float()[..., None]


def paged_verify_quant_ref(q, k_pages, v_pages, k_scale, v_scale, table,
                           kv_len, *, window: Optional[int] = None
                           ) -> torch.Tensor:
    """Plain B4: inflate the int8 pages to f32, then ``paged_verify_ref``."""
    return paged_verify_ref(q, _dequant_pages(k_pages, k_scale),
                            _dequant_pages(v_pages, v_scale), table, kv_len,
                            window=window)
