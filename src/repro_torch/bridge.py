"""Carry the JAX package's parameter trees into the port, and the port's
model into the same tree layout.

The caller converts a JAX tree to numpy first
(``jax.tree.map(np.asarray, params)``), so this module never imports JAX.
The tree is ``embed``, ``final_norm``, optional ``unembed`` and, for the
dense family, ``blocks.{attn_norm, attn.{wq,wk,wv,wo[,bq,bk,bv]},
ffn_norm, ffn.{w_gate,w_up,w_down}}``, for the moe family the same with
``moe.{router, w_gate, w_up, w_down}`` in place of ``ffn`` (router (d,
E), expert stacks (E, d, f) and (E, f, d)), for the ssm family
``blocks.{norm, ssd.{in_proj, conv_w, dt_bias, a_log, d_skip, norm,
out_proj}}``, each block leaf stacked over the L layers. Weights keep
their (in, out) layout, so ``x @ w`` is the same product.

A quantized leaf (the JAX ``QuantizedTensor`` with numpy ``packed`` int8
and ``scale`` bf16 children, as ``quant.quantize_tree`` or
``runtime.serve.quantize_ring_params`` make it) becomes the port's
``QuantizedTensor``; its bf16 scale bits are carried as raw 16-bit words.
``block_from_tree`` builds one ``DenseBlock`` or ``SSDBlock`` from a
per-layer tree, the form ``ParamSource.layer(i)`` returns.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.model import (GLU, MOE_KEYS, SSD, SSD_KEYS, Attention,
                           DenseBlock, DenseModel, MoE, SSDBlock)
from .quant.grouped import QuantizedTensor, map_tree
from .runtime.paramstore import stack_layers

_BLOCK_KEYS = {"attn": ("wq", "wk", "wv", "wo", "bq", "bk", "bv"),
               "ffn": ("w_gate", "w_up", "w_down"), "moe": MOE_KEYS}


def _is_quantized(a) -> bool:
    return all(hasattr(a, k) for k in ("packed", "scale", "bits", "group",
                                       "shape"))


def _bf16(a) -> torch.Tensor:
    """A numpy bf16 array (ml_dtypes) as a torch bf16 tensor, bit-exact."""
    return torch.tensor(np.asarray(a).view(np.int16)).view(torch.bfloat16)


def tree_from_numpy(tree: Dict[str, Any], device="cuda",
                    dtype=torch.float32) -> Dict[str, Any]:
    """The same nested-dict tree with torch leaves on ``device``: float
    leaves in ``dtype``, quantized leaves as the port's
    ``QuantizedTensor`` (packed int8, scale bf16, bit-exact)."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device, dtype) for k, v in tree.items()}
    if _is_quantized(tree):
        return QuantizedTensor(
            packed=torch.tensor(np.asarray(tree.packed, np.int8),
                                device=device),
            scale=_bf16(tree.scale).to(device), bits=int(tree.bits),
            group=int(tree.group), shape=tuple(int(d) for d in tree.shape))
    return torch.tensor(np.asarray(tree, np.float32), dtype=dtype,
                        device=device)


def block_from_tree(p: Dict[str, Any]):
    """One ``DenseBlock`` (or ``SSDBlock``, for a tree with ``ssd``) from a
    per-layer tree (no layer axis); leaves are used as they are, views
    included."""
    if "ssd" in p:
        return SSDBlock(p["norm"], SSD(*(p["ssd"][k] for k in SSD_KEYS)))
    attn = p["attn"]
    bias = [attn[k] for k in ("bq", "bk", "bv")] if "bq" in attn else []
    if "moe" in p:
        ffn = MoE(*(p["moe"][k] for k in MOE_KEYS))
    else:
        ffn = GLU(p["ffn"]["w_gate"], p["ffn"]["w_up"], p["ffn"]["w_down"])
    return DenseBlock(
        p["attn_norm"],
        Attention(attn["wq"], attn["wk"], attn["wv"], attn["wo"], *bias),
        p["ffn_norm"], ffn)


def params_from_numpy(tree: Dict[str, Any], device="cuda",
                      dtype=torch.float32) -> DenseModel:
    t = tree_from_numpy(tree, device, dtype)
    blocks = t["blocks"]
    n_layers = blocks["norm" if "ssd" in blocks else "attn_norm"].shape[0]
    layers = [block_from_tree(map_tree(lambda a: a[i], blocks))
              for i in range(n_layers)]
    return DenseModel(t["embed"], t["final_norm"], layers, t.get("unembed"))


def tree_from_block(block) -> Dict[str, Any]:
    """One block as its per-layer tree (the inverse of
    ``block_from_tree``)."""
    if isinstance(block, SSDBlock):
        return {"norm": block.norm.detach(),
                "ssd": {k: getattr(block.ssd, k).detach()
                        for k in SSD_KEYS}}
    out = {"attn_norm": block.attn_norm.detach(),
           "ffn_norm": block.ffn_norm.detach()}
    for sub, keys in _BLOCK_KEYS.items():
        mod = getattr(block, sub, None)
        if mod is not None:
            out[sub] = {k: getattr(mod, k).detach() for k in keys
                        if hasattr(mod, k)}
    return out


def tree_from_params(params: DenseModel) -> Dict[str, Any]:
    """The model as the JAX package's stacked tree (block leaves stacked
    over the layers on their device): the layout
    ``runtime.paramstore.save_param_store`` and ``ResidentSource`` take."""
    out = {"embed": params.embed.detach(),
           "final_norm": params.final_norm.detach(),
           "blocks": stack_layers([tree_from_block(b)
                                   for b in params.blocks])}
    if hasattr(params, "unembed"):
        out["unembed"] = params.unembed.detach()
    return out
