"""The plain versions of every kernel under the JAX package's names
(``repro.kernels.ref``): the oracles a kernel is held against.

Each is the plain torch function beside its kernel (``q4_matmul.py``,
``flash_decode.py``, ``paged_decode.py``, ``paged_prefill.py``,
``ssd_scan.py``); ``paged_decode_ref`` and ``paged_decode_quant_ref`` are
the T = 1 views of the verify versions, as in the reference.
"""
from __future__ import annotations

from typing import Optional

from .flash_decode import flash_decode_ref, flash_verify_ref
from .paged_decode import paged_verify_quant_ref, paged_verify_ref
from .paged_prefill import paged_prefill_ref
from .q4_matmul import q4_matmul_ref
from .ssd_scan import ssd_scan_ref, ssd_sequential_ref


def paged_decode_ref(q, k_pages, v_pages, table, kv_len, *,
                     window: Optional[int] = None):
    """q: (B, H, D) -> (B, H, D): the T = 1 slice of
    ``paged_verify_ref``."""
    return paged_verify_ref(q[:, None], k_pages, v_pages, table, kv_len,
                            window=window)[:, 0]


def paged_decode_quant_ref(q, k_pages, v_pages, k_scale, v_scale, table,
                           kv_len, *, window: Optional[int] = None):
    """q: (B, H, D) -> (B, H, D): the T = 1 slice of
    ``paged_verify_quant_ref``."""
    return paged_verify_quant_ref(q[:, None], k_pages, v_pages, k_scale,
                                  v_scale, table, kv_len,
                                  window=window)[:, 0]


__all__ = ["q4_matmul_ref", "flash_decode_ref", "flash_verify_ref",
           "paged_verify_ref", "paged_decode_ref", "paged_prefill_ref",
           "paged_verify_quant_ref", "paged_decode_quant_ref",
           "ssd_scan_ref", "ssd_sequential_ref"]
