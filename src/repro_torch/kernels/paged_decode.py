"""Paged decode/verify attention: the CUDA kernels B1 (float pages) and B4
(int8 pages) and their plain torch versions.

Counterpart of ``repro/kernels/paged_decode.py`` (Pallas). B1 lives in
``csrc/paged_attention.cu``; B4 (and B2, ``paged_prefill.py``) in
``csrc/paged_tiles.cu``, on the tensor cores: a 128-row tile kernel for
chunk rows (design 1) and, at decode and verify (T * n_rep <= 64 rows),
the same tile code with the pages split across CTAs and a second pass that
merges the splits (design 2). ``tile_plan`` picks the design from shapes
alone. These wrappers check what they are given, allocate the output (and
design 2's scratch) and launch on the current stream without
synchronising. They take CUDA tensors only — ``kernels.ops`` routes CPU
tensors to the plain versions beside them.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

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
    return B, T, H, h_kv, D, bs, table.shape[1]


def _check_smem(smem: int, name: str, what: str) -> None:
    if smem < 0 or smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {what} needs {smem} B of shared memory "
                         f"per CTA (-1: not built for it); limit "
                         f"{SMEM_LIMIT}")


def _window(window: Optional[int]) -> int:
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    return -1 if window is None else int(window)


def paged_verify(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, table: torch.Tensor,
                 kv_len: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """B1 (``csrc/paged_attention.cu``). q: (B, T, H, D) f32/bf16;
    k_pages/v_pages: (P, bs, h_kv, D) f32/bf16 in their stored layout;
    table: (B, nb) int32; kv_len: (B,) int32 valid positions *including*
    the T query tokens -> (B, T, H, D) in q.dtype. Table entries past
    ``ceil(kv_len/bs)`` are never read."""
    name = "paged_verify"
    B, T, H, h_kv, D, bs, nb = _check_common(q, k_pages, v_pages, table,
                                             kv_len, name)
    floats = (torch.float32, torch.bfloat16)
    qc = _code(q, floats, f"{name} q")
    kc = _code(k_pages, floats, f"{name} pages")
    lib = _build.load("paged_attention")
    _check_smem(lib.paged_attention_smem_bytes(T, H, h_kv, D, bs), name,
                f"a page of {bs} tokens x D={D}")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    code = lib.paged_verify(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), qc, kc,
        B, T, H, h_kv, D, bs, nb, _window(window), 1.0 / math.sqrt(D),
        *q.stride()[:3], *k_pages.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, name, "paged_attention")
    _build.LAUNCHES[name] += 1
    return out


def paged_decode(q, k_pages, v_pages, table, kv_len, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, D) -> (B, H, D): the T = 1 slice of ``paged_verify``."""
    return paged_verify(q[:, None], k_pages, v_pages, table, kv_len,
                        window=window)[:, 0]


#: most rows a design-2 CTA takes (4 warps x 16 rows of the m16n8k16
#: tile); more rows take design 1's 128-row tiles (8 warps)
SPLIT_ROWS = 64
#: keys a design-2 CTA walks (4 blocks of 64)
SPLIT_KEYS = 256
#: head dims the tile kernels are built for
TILE_DIMS = (64, 128)


@dataclass(frozen=True)
class TilePlan:
    """How one B2/B4 call runs on ``csrc/paged_tiles.cu``: ``design`` 1
    (chunk-row tiles, one pass) or 2 (pages split across ``n_split`` CTAs
    of ``split_pages`` pages, then a pass that merges the splits);
    ``key_split`` warps share one 16-row tile, each taking a part of every
    key block; design 2's f32 scratch shapes (acc, then m and l)."""
    design: int
    key_split: int
    n_split: int
    split_pages: int
    scratch: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]


@functools.lru_cache(maxsize=None)
def tile_plan(B: int, T: int, H: int, h_kv: int, D: int, bs: int, nb: int,
              *, quant: bool) -> TilePlan:
    """The route of a B2 (``quant=False``) or B4 call, from shapes alone:
    never from kv_len, which lives on the card."""
    rows = T * (H // h_kv)
    if quant and rows <= SPLIT_ROWS:
        key_split = 4 if rows <= 16 else 2 if rows <= 32 else 1
        split_pages = max(1, SPLIT_KEYS // bs)
        n_split = -(-nb // split_pages)
        return TilePlan(2, key_split, n_split, split_pages,
                        ((B, h_kv, n_split, rows, D),
                         (2, B, h_kv, n_split, rows)))
    return TilePlan(1, 1, 1, nb, None)


def _check_aligned(name: str, **tensors) -> None:
    """The tile kernels copy q and page rows 16 bytes at a time: pointers,
    row widths and the strides of the leading three dims must be 16-byte
    aligned."""
    for what, t in tensors.items():
        elt = t.element_size()
        st = t.stride()
        if (t.data_ptr() | (t.shape[-1] | st[0] | st[1] | st[2]) * elt) % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned for "
                             f"cp.async (pointer {t.data_ptr():#x}, "
                             f"strides {t.stride()}, {elt} B elements)")


@functools.lru_cache(maxsize=None)
def _tile_smem(q_code: int, kv_code: int, D: int, key_split: int,
               design: int) -> int:
    return _build.load("paged_tiles").paged_tiles_smem_bytes(
        q_code, kv_code, D, key_split, int(design == 2))


def _launch_tiles(name: str, q, k_pages, v_pages, table, kv_len,
                  window: Optional[int], k_scale=None,
                  v_scale=None) -> torch.Tensor:
    """B2 (float pages) or B4 (int8 pages with their scales) on the tile
    kernels; one count per call, whichever design runs."""
    B, T, H, h_kv, D, bs, nb = _check_common(q, k_pages, v_pages, table,
                                             kv_len, name)
    floats = (torch.float32, torch.bfloat16)
    qc = _code(q, floats, f"{name} q")
    quant = k_scale is not None
    if quant:
        kc = _code(k_pages, (torch.int8,), f"{name} pages")
        sc = _code(k_scale, floats, f"{name} scales")
        if k_scale.shape != k_pages.shape[:3] \
                or v_scale.shape != k_scale.shape \
                or v_scale.dtype != k_scale.dtype \
                or k_scale.stride() != v_scale.stride():
            raise ValueError(f"{name}: scales must be matching "
                             f"(P, bs, h_kv)")
        for t in (k_scale, v_scale):
            if t.device != q.device:
                raise ValueError(f"{name}: scales on {t.device}, q on "
                                 f"{q.device}")
        sc_strides = k_scale.stride()
    else:
        kc = _code(k_pages, floats, f"{name} pages")
        sc, sc_strides = 0, (0, 0, 0)
    if D not in TILE_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {TILE_DIMS}")
    _check_aligned(name, q=q, k_pages=k_pages, v_pages=v_pages)
    plan = tile_plan(B, T, H, h_kv, D, bs, nb, quant=quant)
    lib = _build.load("paged_tiles")
    _check_smem(_tile_smem(qc, kc, D, plan.key_split, plan.design), name,
                f"design {plan.design} at D={D}")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    part_acc = part_ml = k_ptr = v_ptr = None
    if quant:
        k_ptr, v_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    if plan.scratch is not None:        # acc, then m and l, in one buffer
        n_acc = math.prod(plan.scratch[0])
        scratch = torch.empty(n_acc + math.prod(plan.scratch[1]),
                              dtype=torch.float32, device=q.device)
        part_acc = scratch.data_ptr()
        part_ml = part_acc + 4 * n_acc
    code = lib.paged_tiles(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_ptr, v_ptr,
        table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), part_acc,
        part_ml, qc, kc, sc, B, T, H,
        h_kv, D, bs, nb, _window(window), 1.0 / math.sqrt(D),
        plan.key_split, plan.n_split, plan.split_pages, *q.stride()[:3],
        *k_pages.stride()[:3], *sc_strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, name, "paged_tiles")
    _build.LAUNCHES[name] += 1
    return out


def paged_verify_quant(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, table: torch.Tensor,
                       kv_len: torch.Tensor, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """B4. ``paged_verify`` over int8 pages (P, bs, h_kv, D) with
    per-(position, kv-head) scales (P, bs, h_kv) stored in the pool dtype
    (f32 or bf16); the int8 bytes are widened inside the kernel. Any T:
    ``tile_plan`` gives decode and verify rows design 2, chunk rows
    design 1."""
    return _launch_tiles("paged_verify_quant", q, k_pages, v_pages, table,
                         kv_len, window, k_scale, v_scale)


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
