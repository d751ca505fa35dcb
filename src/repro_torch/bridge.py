"""Carry the JAX package's parameter pytree into the port's modules.

The caller converts the JAX tree to numpy first
(``jax.tree.map(np.asarray, params)``), so this module never imports JAX.
The tree is ``embed``, ``final_norm``, optional ``unembed`` and
``blocks.{attn_norm, attn.{wq,wk,wv,wo[,bq,bk,bv]}, ffn_norm,
ffn.{w_gate,w_up,w_down}}``, each block leaf stacked over the L layers.
Weights keep their (in, out) layout, so ``x @ w`` is the same product.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.model import GLU, Attention, DenseBlock, DenseModel


def params_from_numpy(tree: Dict[str, Any], device="cuda",
                      dtype=torch.float32) -> DenseModel:
    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=device)

    blocks = tree["blocks"]
    attn, ffn = blocks["attn"], blocks["ffn"]
    n_layers = np.asarray(blocks["attn_norm"]).shape[0]
    layers = []
    for i in range(n_layers):
        bias = [t(attn[k][i]) for k in ("bq", "bk", "bv")] \
            if "bq" in attn else []
        layers.append(DenseBlock(
            t(blocks["attn_norm"][i]),
            Attention(*(t(attn[k][i]) for k in ("wq", "wk", "wv", "wo")),
                      *bias),
            t(blocks["ffn_norm"][i]),
            GLU(*(t(ffn[k][i]) for k in ("w_gate", "w_up", "w_down")))))
    unembed = t(tree["unembed"]) if "unembed" in tree else None
    return DenseModel(t(tree["embed"]), t(tree["final_norm"]), layers,
                      unembed)
