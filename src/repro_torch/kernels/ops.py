"""Dispatch of the port's kernels: paged attention (B1, B2, B4) and
contiguous-cache attention (B5), all four on ``csrc/paged_tiles.cu``, the
q4 matmul (B3) and the SSD scan (B6).

A tensor on the CPU goes to the kernel's plain torch version; a CUDA
tensor launches the CUDA kernel, which raises when it cannot run — there
is no fallback. ``use_kernels(False)`` forces the plain versions (tests
and ``chip_smoke.py`` compare the two), mirroring ``repro.kernels.ops``.
The model path asks ``kernels_active`` once per attention call, in
``models.layers._paged_attention`` and ``models.layers._dense_attention``,
and calls the kernel wrappers itself (``layers.qmm`` goes through
``q4_matmul`` below, ``layers.ssd_block``'s zero-state prefill through
``ssd_scan``); the functions below route a direct call of one kernel.
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


def q4_matmul(x, packed, scale, *, group: int = 64):
    if not kernels_active(x):
        return _q4.q4_matmul_ref(x, packed, scale, group=group)
    return _q4.q4_matmul(x, packed, scale, group=group)


def ssd_scan(x, dt, A, Bmat, Cmat, *, chunk: int = 128):
    if not kernels_active(x):
        return _ssd.ssd_scan_ref(x, dt, A, Bmat, Cmat, chunk=chunk)
    return _ssd.ssd_scan(x, dt, A, Bmat, Cmat, chunk=chunk)


def flash_verify(q, k, v, kv_len, *, window: Optional[int] = None,
                 k_scale=None, v_scale=None):
    if not kernels_active(q):
        return _fd.flash_verify_ref(q, k, v, kv_len, window=window,
                                    k_scale=k_scale, v_scale=v_scale)
    return _fd.flash_verify(q, k, v, kv_len, window=window, k_scale=k_scale,
                            v_scale=v_scale)


def flash_decode(q, k, v, kv_len, *, window: Optional[int] = None,
                 k_scale=None, v_scale=None):
    if not kernels_active(q):
        return _fd.flash_decode_ref(q, k, v, kv_len, window=window,
                                    k_scale=k_scale, v_scale=v_scale)
    return _fd.flash_decode(q, k, v, kv_len, window=window, k_scale=k_scale,
                            v_scale=v_scale)


def paged_verify(q, k_pages, v_pages, table, kv_len, *,
                 window: Optional[int] = None):
    if not kernels_active(q):
        return _pd.paged_verify_ref(q, k_pages, v_pages, table, kv_len,
                                    window=window)
    return _pd.paged_verify(q, k_pages, v_pages, table, kv_len,
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
    return _pp.paged_prefill(q, k_pages, v_pages, table, kv_len,
                             window=window)


def paged_verify_quant(q, k_pages, v_pages, k_scale, v_scale, table, kv_len,
                       *, window: Optional[int] = None):
    if not kernels_active(q):
        return _pd.paged_verify_quant_ref(q, k_pages, v_pages, k_scale,
                                          v_scale, table, kv_len,
                                          window=window)
    return _pd.paged_verify_quant(q, k_pages, v_pages, k_scale, v_scale,
                                  table, kv_len, window=window)


def paged_decode_quant(q, k_pages, v_pages, k_scale, v_scale, table,
                       kv_len, *, window: Optional[int] = None):
    return paged_verify_quant(q[:, None], k_pages, v_pages, k_scale,
                              v_scale, table, kv_len, window=window)[:, 0]
