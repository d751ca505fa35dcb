"""Dispatch of the port's kernels: paged attention (B1, B2, B4) and
contiguous-cache attention (B5, and B5 with its row stats for the ring's
sequence-split merge), all on ``csrc/paged_tiles.cu``, the q4 matmul (B3)
and the SSD scan (B6).

A tensor on the CPU goes to the kernel's plain torch version; a CUDA
tensor launches the CUDA kernel, which raises when it cannot run — there
is no fallback. ``use_kernels(False)`` forces the plain versions (tests
and ``chip_smoke.py`` compare the two), mirroring ``repro.kernels.ops``.
The model path asks ``kernels_active`` once per attention call, in
``models.layers._paged_attention`` and ``models.layers._dense_attention``,
and calls the kernel wrappers itself (``layers.qmm`` goes through
``q4_matmul`` below, ``layers.ssd_block``'s zero-state prefill through
``ssd_scan``); the functions below route a direct call of one kernel.

A kernel fills its output through a raw pointer, so that output carries
no ``grad_fn``. B6 is wrapped in ``ssd_scan.SSDScan``, whose backward
differentiates the plain scan; every other kernel is refused, through
``_launch``, while grad is enabled and one of its inputs requires grad,
so a training path cannot lose a gradient without a word.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from . import flash_decode as _fd
from . import paged_decode as _pd
from . import paged_prefill as _pp
from . import q4_matmul as _q4
from . import ssd_scan as _ssd

_FORCE_REF = False


def use_kernels(enable: bool) -> None:
    global _FORCE_REF
    _FORCE_REF = not enable


def kernels_active(t: torch.Tensor) -> bool:
    """True when a call on ``t`` launches the CUDA kernel."""
    return not _FORCE_REF and t.device.type == "cuda"


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, one plain integer each."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0


def _launch(kernel, *args, **kw):
    """``kernel(*args, **kw)``, refused with ``RuntimeError`` while grad
    is enabled and a tensor argument requires grad: its output would
    carry no ``grad_fn``."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in (*args, *kw.values())):
        raise RuntimeError(
            f"{kernel.__name__}: the CUDA kernel has no backward, and an "
            f"input requires grad; call it under torch.no_grad() or with "
            f"ops.use_kernels(False)")
    return kernel(*args, **kw)


def q4_matmul(x, packed, scale, *, group: int = 64):
    if not kernels_active(x):
        return _q4.q4_matmul_ref(x, packed, scale, group=group)
    return _launch(_q4.q4_matmul, x, packed, scale, group=group)


def ssd_scan(x, dt, A, Bmat, Cmat, *, chunk: int = 128):
    """B6 under autograd (``ssd_scan.SSDScan``) on the card."""
    if not kernels_active(x):
        return _ssd.ssd_scan_ref(x, dt, A, Bmat, Cmat, chunk=chunk)
    return _ssd.SSDScan.apply(_ssd.ssd_scan, x, dt, A, Bmat, Cmat, chunk)


def flash_verify(q, k, v, kv_len, *, window: Optional[int] = None,
                 k_scale=None, v_scale=None):
    if not kernels_active(q):
        return _fd.flash_verify_ref(q, k, v, kv_len, window=window,
                                    k_scale=k_scale, v_scale=v_scale)
    return _launch(_fd.flash_verify, q, k, v, kv_len, window=window,
                   k_scale=k_scale, v_scale=v_scale)


def flash_verify_stats(q, k, v, kv_len, *, window: Optional[int] = None,
                       k_scale=None, v_scale=None):
    """B5 with its stats: (o, lse (B, H, T) f32)."""
    if not kernels_active(q):
        return _fd.flash_verify_stats_ref(q, k, v, kv_len, window=window,
                                          k_scale=k_scale, v_scale=v_scale)
    return _launch(_fd.flash_verify_stats, q, k, v, kv_len, window=window,
                   k_scale=k_scale, v_scale=v_scale)


def flash_decode(q, k, v, kv_len, *, window: Optional[int] = None,
                 k_scale=None, v_scale=None):
    return flash_verify(q[:, None], k, v, kv_len, window=window,
                        k_scale=k_scale, v_scale=v_scale)[:, 0]


def paged_verify(q, k_pages, v_pages, table, kv_len, *,
                 window: Optional[int] = None):
    if not kernels_active(q):
        return _pd.paged_verify_ref(q, k_pages, v_pages, table, kv_len,
                                    window=window)
    return _launch(_pd.paged_verify, q, k_pages, v_pages, table, kv_len,
                   window=window)


def paged_decode(q, k_pages, v_pages, table, kv_len, *,
                 window: Optional[int] = None):
    return paged_verify(q[:, None], k_pages, v_pages, table, kv_len,
                        window=window)[:, 0]


def paged_prefill(q, k_pages, v_pages, table, kv_len, *,
                  window: Optional[int] = None):
    if not kernels_active(q):
        return _pp.paged_prefill_ref(q, k_pages, v_pages, table, kv_len,
                                     window=window)
    return _launch(_pp.paged_prefill, q, k_pages, v_pages, table, kv_len,
                   window=window)


def paged_verify_quant(q, k_pages, v_pages, k_scale, v_scale, table, kv_len,
                       *, window: Optional[int] = None):
    if not kernels_active(q):
        return _pd.paged_verify_quant_ref(q, k_pages, v_pages, k_scale,
                                          v_scale, table, kv_len,
                                          window=window)
    return _launch(_pd.paged_verify_quant, q, k_pages, v_pages, k_scale,
                   v_scale, table, kv_len, window=window)


def paged_decode_quant(q, k_pages, v_pages, k_scale, v_scale, table,
                       kv_len, *, window: Optional[int] = None):
    return paged_verify_quant(q[:, None], k_pages, v_pages, k_scale,
                              v_scale, table, kv_len, window=window)[:, 0]
