"""Paged chunked-prefill attention: the CUDA kernel B2 and its plain torch
version.

Counterpart of ``repro/kernels/paged_prefill.py`` (Pallas). One prompt
chunk of S rows per sequence attends over the pages the table addresses,
row t at absolute position ``kv_len - S + t``. The kernel is design 1 of
``csrc/paged_tiles.cu``: one CTA per 128-row tile of a kv head's group
(the n_rep query heads packed into the rows), K/V blocks of 64 keys
gathered through the table with ``cp.async`` into a two-stage ring, and
S = Q.K^T and O += P.V on the tensor cores (``mma.sync`` m16n8k16, bf16
pieces, f32 sums). It never loads dead pages: those at or past the tile's
causal frontier and those behind its sliding window.
"""
from __future__ import annotations

from typing import Optional

import torch

from .paged_decode import _launch_tiles


def paged_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, table: torch.Tensor,
                  kv_len: torch.Tensor, *,
                  window: Optional[int] = None) -> torch.Tensor:
    """B2. q: (B, S, H, D) f32/bf16 — one chunk whose KV the caller
    already wrote through the table; pages (P, bs, h_kv, D) f32/bf16;
    table (B, nb) int32; kv_len (B,) int32 including the chunk ->
    (B, S, H, D) in q.dtype. Each row uses its own sequence's kv_len."""
    return _launch_tiles("paged_prefill", q, k_pages, v_pages, table,
                         kv_len, window)


def paged_prefill_ref(q, k_pages, v_pages, table, kv_len, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """Plain B2: the verify geometry with T = S (per-row kv_len), as
    ``repro.kernels.ref.paged_prefill_ref``."""
    from ..models.layers import paged_verify_attention
    return paged_verify_attention(q, k_pages, v_pages, table, kv_len,
                                  window=window)
