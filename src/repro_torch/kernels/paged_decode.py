"""Paged decode/verify attention: the CUDA kernels B1 (float pages) and B4
(int8 pages), the tile kernels' plan and checks, and the plain torch
versions.

Counterpart of ``repro/kernels/paged_decode.py`` (Pallas). B1, B4, B2
(``paged_prefill.py``) and B5 (``flash_decode.py``, a contiguous cache)
all run on ``csrc/paged_tiles.cu``, on the tensor cores: a 128-row tile
kernel for chunk rows (design 1) and, at decode and verify (T * n_rep <= 64
rows) and on every B5 call, the same tile code with the keys split across
CTAs and a second pass that merges the splits (design 2). ``tile_plan``
picks the design from shapes alone. Head dims: any multiple of 16 from 16
to 256 (``check_head_dim``). These wrappers check what they are given,
allocate the output (and design 2's scratch) and launch on the current
stream without synchronising. They take CUDA tensors only --
``kernels.ops`` routes CPU tensors to the plain versions beside them.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FLOATS = (torch.float32, torch.bfloat16)
#: dynamic shared memory a CTA may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
#: most rows a B1/B4 call runs as design 2 (split keys); more rows take
#: design 1's 128-row tiles (8 warps)
SPLIT_ROWS = 64
#: keys a design-2 CTA walks (4 blocks of 64)
SPLIT_KEYS = 256
#: design 2's key split, by pool dtype: the warps that share a row tile,
#: each taking a fixed part of every key block (f32 pools: blocks of 32
#: keys, 2 warps; others: 64 keys, 4 warps). It depends on the pool alone,
#: never on T (but B4 at D_pad <= 128 picks its own from the rows)
SPLIT_WARPS = {torch.float32: 2, torch.bfloat16: 4, torch.int8: 4}
#: the head dims the tile kernels take
HEAD_DIM_RULE = "D % 16 == 0 and 16 <= D <= 256"


def check_head_dim(name: str, D: int) -> int:
    """The tile width a head dim ``D`` runs on (64, 128 or 256: the head
    is staged zero-padded to it); raises ``ValueError`` off the rule."""
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"{name}: head dim {D} is not supported by the "
                         f"tile kernels (the rule: {HEAD_DIM_RULE})")
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _code(t: torch.Tensor, allowed, what: str) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        f"(expected one of {allowed})")
    return _CODES[t.dtype]


def _check_devices(name: str, q, *tensors) -> None:
    for t in (q, *tensors):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device (got {t.device}, q on {q.device})")


def _check_q(q, k, v, name: str, what: str):
    """The checks a pool and a cache share; returns (B, T, H, h_kv, D)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q must be (B, T, H, D) and {what}")
    B, T, H, D = q.shape
    check_head_dim(name, D)
    h_kv, Dk = k.shape[2:]
    if Dk != D or v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v must share strides")
    if H % h_kv:
        raise ValueError(f"{name}: {H} heads not a multiple of {h_kv}")
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError(f"{name}: q and k/v need a contiguous last dim")
    return B, T, H, h_kv, D


def _check_kv_len(kv_len, B: int, name: str) -> None:
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,) \
            or not kv_len.is_contiguous():
        raise TypeError(f"{name}: kv_len must be contiguous (B,) int32")


def _check_common(q, k_pages, v_pages, table, kv_len, name: str):
    """Validate a paged call's geometry; returns (B, T, H, h_kv, D, bs,
    nb)."""
    B, T, H, h_kv, D = _check_q(q, k_pages, v_pages, name,
                                "pages (P, bs, h_kv, D)")
    _check_devices(name, q, k_pages, v_pages, table, kv_len)
    if table.dtype != torch.int32:
        raise TypeError(f"{name}: table must be int32")
    if table.dim() != 2 or table.shape[0] != B or not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous (B, nb)")
    _check_kv_len(kv_len, B, name)
    if B == 0 or T == 0:
        raise ValueError(f"{name}: empty batch or query block")
    return B, T, H, h_kv, D, k_pages.shape[1], table.shape[1]


def _check_cache(q, k, v, kv_len, name: str):
    """Validate a contiguous-cache call's geometry; returns (B, T, H, h_kv,
    D, S)."""
    B, T, H, h_kv, D = _check_q(q, k, v, name, "k/v (B, S, h_kv, D)")
    _check_devices(name, q, k, v, kv_len)
    if k.shape[0] != B:
        raise ValueError(f"{name}: k/v batch {k.shape[0]} is not q's {B}")
    _check_kv_len(kv_len, B, name)
    if B == 0 or T == 0 or k.shape[1] == 0:
        raise ValueError(f"{name}: empty batch, query block or cache")
    return B, T, H, h_kv, D, k.shape[1]


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
    """B1. q: (B, T, H, D) f32/bf16; k_pages/v_pages: (P, bs, h_kv, D)
    f32/bf16 in their stored layout; table: (B, nb) int32; kv_len: (B,)
    int32 valid positions *including* the T query tokens -> (B, T, H, D)
    in q.dtype. Table entries past ``ceil(kv_len/bs)`` are never read.
    ``tile_plan`` gives decode and verify rows design 2, more rows design
    1."""
    return _launch_tiles("paged_verify", q, k_pages, v_pages, table, kv_len,
                         window)


def paged_decode(q, k_pages, v_pages, table, kv_len, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, D) -> (B, H, D): the T = 1 slice of ``paged_verify``."""
    return paged_verify(q[:, None], k_pages, v_pages, table, kv_len,
                        window=window)[:, 0]


@dataclass(frozen=True)
class TilePlan:
    """How one call runs on ``csrc/paged_tiles.cu``: ``design`` 1
    (chunk-row tiles, one pass) or 2 (keys split across ``n_split`` CTAs
    of ``split_pages`` pages -- a contiguous cache counts its lines as
    pages of one -- then a pass that merges the splits); ``key_split``
    warps share one row tile, each taking a fixed part of every key
    block; the head is staged ``d_pad`` wide; design 2's f32 scratch
    shapes (acc, then m and l)."""
    design: int
    key_split: int
    n_split: int
    split_pages: int
    d_pad: int
    scratch: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]


@functools.lru_cache(maxsize=None)
def tile_plan(B: int, T: int, H: int, h_kv: int, D: int, bs: int, nb: int,
              *, pool: torch.dtype, kernel: str) -> TilePlan:
    """The route of one call of ``kernel`` (``paged_verify``,
    ``paged_prefill``, ``paged_verify_quant`` or ``flash_verify``, whose
    cache passes bs = 1 and nb = S) over a pool of dtype ``pool``, from
    shapes alone: never from kv_len, which lives on the card. B2 always
    takes design 1, B5 always design 2, B1 and B4 design 2 at
    T * n_rep <= SPLIT_ROWS. Design 2's split boundaries (SPLIT_KEYS keys)
    and, for B1 and B5, key split follow from the pool alone, so row t of
    a verify call sums its keys in the order a decode step at its
    position does."""
    d_pad = check_head_dim(kernel, D)
    rows = T * (H // h_kv)
    if kernel == "paged_prefill" or (kernel != "flash_verify"
                                     and rows > SPLIT_ROWS):
        return TilePlan(1, 1, 1, nb, d_pad, None)
    split_pages = max(1, SPLIT_KEYS // bs)
    n_split = -(-nb // split_pages)
    key_split = SPLIT_WARPS[pool]
    if kernel == "paged_verify_quant" and d_pad <= 128:
        # B4 keeps the plan of its rows (one row tile a split): its verify
        # rows past 16 sum in another order than its decode steps
        key_split = 4 if rows <= 16 else 2 if rows <= 32 else 1
    return TilePlan(2, key_split, n_split, split_pages, d_pad,
                    ((B, h_kv, n_split, rows, d_pad),
                     (2, B, h_kv, n_split, rows)))


def _check_aligned(name: str, **tensors) -> None:
    """The tile kernels copy q and K/V rows 16 bytes at a time: pointers,
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


def _launch_tiles(name: str, q, k, v, table, kv_len,
                  window: Optional[int], k_scale=None,
                  v_scale=None, stats: bool = False):
    """B1 or B2 (float pages), B4 (int8 pages with their scales) or, with
    ``table`` None, B5 over a contiguous (B, S, h_kv, D) cache (float, or
    int8 with its (B, S, h_kv) scales) on the tile kernels; one count per
    call, whichever design runs. ``stats`` (B5 only): also each row's
    natural-log log-sum-exp, returned as (out, lse (B, H, T) f32)."""
    if table is None:
        B, T, H, h_kv, D, S = _check_cache(q, k, v, kv_len, name)
        bs, nb = 1, S
    else:
        B, T, H, h_kv, D, bs, nb = _check_common(q, k, v, table, kv_len,
                                                 name)
    qc = _code(q, _FLOATS, f"{name} q")
    quant = k_scale is not None
    if quant:
        kc = _code(k, (torch.int8,), f"{name} k/v")
        sc = _code(k_scale, _FLOATS, f"{name} scales")
        if v_scale is None or k_scale.shape != k.shape[:3] \
                or v_scale.shape != k_scale.shape \
                or v_scale.dtype != k_scale.dtype \
                or k_scale.stride() != v_scale.stride():
            raise ValueError(f"{name}: scales must be matching "
                             f"{tuple(k.shape[:3])}")
        for t in (k_scale, v_scale):
            if t.device != q.device:
                raise ValueError(f"{name}: scales on {t.device}, q on "
                                 f"{q.device}")
        sc_strides = k_scale.stride()
    else:
        kc = _code(k, _FLOATS, f"{name} k/v")
        sc, sc_strides = 0, (0, 0, 0)
    _check_aligned(name, q=q, k=k, v=v)
    plan = tile_plan(B, T, H, h_kv, D, bs, nb, pool=k.dtype,
                     kernel=name.removesuffix("_stats"))
    lib = _build.load("paged_tiles")
    _check_smem(_tile_smem(qc, kc, D, plan.key_split, plan.design), name,
                f"design {plan.design} at D={D}")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    part_acc = part_ml = k_ptr = v_ptr = lse = None
    if stats:
        if plan.scratch is None:
            raise ValueError(f"{name}: row stats come from design 2 only")
        lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if quant:
        k_ptr, v_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    if plan.scratch is not None:        # acc, then m and l, in one buffer
        n_acc = math.prod(plan.scratch[0])
        scratch = torch.empty(n_acc + math.prod(plan.scratch[1]),
                              dtype=torch.float32, device=q.device)
        part_acc = scratch.data_ptr()
        part_ml = part_acc + 4 * n_acc
    code = lib.paged_tiles(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_ptr, v_ptr,
        None if table is None else table.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), part_acc, part_ml,
        None if lse is None else lse.data_ptr(), qc, kc, sc,
        int(table is None),
        B, T, H, h_kv, D, bs, nb, _window(window), 1.0 / math.sqrt(D),
        plan.key_split, plan.n_split, plan.split_pages, *q.stride()[:3],
        *k.stride()[:3], *sc_strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, name, "paged_tiles")
    _build.LAUNCHES[name] += 1
    return out if lse is None else (out, lse)


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
    """(P, bs, h_kv, D) int8 + (P, bs, h_kv) scales -> f32 pages (a
    contiguous cache's (B, S, h_kv, D) lines likewise)."""
    return pages.float() * scale.float()[..., None]


def paged_verify_quant_ref(q, k_pages, v_pages, k_scale, v_scale, table,
                           kv_len, *, window: Optional[int] = None
                           ) -> torch.Tensor:
    """Plain B4: inflate the int8 pages to f32, then ``paged_verify_ref``."""
    return paged_verify_ref(q, _dequant_pages(k_pages, k_scale),
                            _dequant_pages(v_pages, v_scale), table, kv_len,
                            window=window)
