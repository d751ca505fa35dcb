"""Ring serving of the port — so far only the packed-int4 layer bank
(``repro.runtime.serve.quantize_ring_params``); the ring itself is ROADMAP
Queue A item 7.

The serve driver quantizes the layer store with it at ``tp=1``: every
matmul weight of the bank goes to packed q4 with bf16 group scales, which
the layer-wise path feeds to kernel B3 (``layers.qmm``).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from ..configs.base import ModelConfig
from ..quant.grouped import quantize_q4

Params = Dict[str, Any]

#: per-layer matmul weights eligible for int4 ring storage (norms, biases,
#: convs, gates stay in their dtype — small and numerically sensitive)
RING_QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router",
    "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "in_proj", "out_proj",
    "w_x", "w_y", "w_out"})

#: leaves whose contraction dim is model-sharded in ring TP — their scale
#: rows (K/group) must stay divisible by tp
_RING_TP_CONTRACTION = frozenset({"w_down", "out_proj"})


def quantize_ring_params(params: Params, cfg: ModelConfig, *,
                         tp: int = 16) -> Tuple[Params, List[str]]:
    """Store the layer bank (``params["blocks"]``, layer-stacked) in packed
    int4 with bf16 group scales.

    Returns ``(params, skipped)``: ``skipped`` lists the eligible matmul
    leaves left unquantized because no group size met the sharding
    constraints. The group adapts per leaf: 64, else 32 or 16 where a
    TP-sharded contraction dim needs it.
    """
    skipped: List[str] = []

    def pick_group(key: str, K: int) -> Optional[int]:
        for g in (64, 32, 16):
            if K % g:
                continue
            if key in _RING_TP_CONTRACTION and (K // g) % tp:
                continue
            if K // g < 1:
                continue
            return g
        return None

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                eligible = (k in RING_QUANT_KEYS and hasattr(v, "ndim")
                            and v.ndim >= 3)
                g = pick_group(k, v.shape[-2]) if eligible else None
                if g:
                    out[k] = quantize_q4(v, group=g)
                else:
                    if eligible:
                        skipped.append(f"{prefix}{k} (K={v.shape[-2]})")
                    out[k] = walk(v, f"{prefix}{k}/")
            return out
        return tree

    out = dict(params)
    out["blocks"] = walk(params["blocks"])
    if skipped:
        logging.getLogger(__name__).warning(
            "quantize_ring_params: %d leaves left unquantized (no group "
            "size fits K and tp=%d): %s", len(skipped), tp,
            ", ".join(skipped))
    return out, skipped
