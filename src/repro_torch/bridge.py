"""Carry the JAX package's parameter trees into the port, and the port's
model into the same tree layout.

The caller converts a JAX tree to numpy first
(``jax.tree.map(np.asarray, params)``), so this module never imports JAX.
The tree is ``embed``, ``final_norm``, optional ``unembed`` and, for the
dense and vlm families, ``blocks.{attn_norm, attn.{wq,wk,wv,wo[,bq,bk,
bv]}, ffn_norm, ffn.{w_gate,w_up,w_down}}``, MLA's ``attn.{wq_a, q_norm,
wq_b, wkv_a, kv_norm, wk_b, wv_b, wo}`` in place of the GQA leaves, for
the moe family ``moe.{router, w_gate, w_up, w_down}`` in place of ``ffn``
(router (d, E), expert stacks (E, d, f) and (E, f, d)), for the ssm
family ``blocks.{norm, ssd.{in_proj, conv_w, dt_bias, a_log, d_skip,
norm, out_proj}}``, each block leaf stacked over the L layers. The hybrid
family's blocks are ``groups.b<i>`` (block kind i of the pattern, stacked
over the G groups) and ``tail``; an RG-LRU block is ``{mix_norm,
ffn_norm, rglru.{w_x, w_y, conv_w, gate_i, gate_r, lambda, w_out},
ffn}``. Whisper's are ``enc_blocks`` (dense blocks), ``enc_norm`` and
``dec_blocks`` ({attn_norm, cross_norm, ffn_norm, attn, cross, ffn}).
Weights keep their (in, out) layout, so ``x @ w`` is the same product.

A quantized leaf (the JAX ``QuantizedTensor`` with numpy ``packed`` int8
and ``scale`` bf16 children, as ``quant.quantize_tree`` or
``runtime.serve.quantize_ring_params`` make it) becomes the port's
``QuantizedTensor``; its bf16 scale bits are carried as raw 16-bit words.
``block_from_tree`` builds one block from a per-layer tree, the form
``ParamSource.layer(i)`` returns.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.model import (GLU, MLA, MLA_KEYS, MOE_KEYS, RGLRU, RGLRU_KEYS,
                           SSD, SSD_KEYS, Attention, DecBlock, DenseBlock,
                           DenseModel, MoE, RGLRUBlock, SSDBlock,
                           WhisperModel)
from .quant.grouped import QuantizedTensor, map_tree, tree_tensors
from .runtime.paramstore import stack_layers

_ATTN_KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv") + MLA_KEYS
_BLOCK_KEYS = {"attn": _ATTN_KEYS, "cross": _ATTN_KEYS,
               "ffn": ("w_gate", "w_up", "w_down"), "moe": MOE_KEYS,
               "rglru": RGLRU_KEYS}
_NORMS = ("attn_norm", "cross_norm", "mix_norm", "ffn_norm")


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


def _attn_from_tree(a: Dict[str, Any]):
    if "wq_a" in a:
        return MLA(*(a[k] for k in MLA_KEYS))
    bias = [a[k] for k in ("bq", "bk", "bv")] if "bq" in a else []
    return Attention(a["wq"], a["wk"], a["wv"], a["wo"], *bias)


def _glu(f: Dict[str, Any]) -> GLU:
    return GLU(f["w_gate"], f["w_up"], f["w_down"])


def block_from_tree(p: Dict[str, Any]):
    """One block from a per-layer tree (no layer axis): an ``SSDBlock``
    (a tree with ``ssd``), an ``RGLRUBlock`` (``rglru``), whisper's
    ``DecBlock`` (``cross``), else a ``DenseBlock`` (GQA or MLA
    attention, GLU or MoE). Leaves are used as they are, views
    included."""
    if "ssd" in p:
        return SSDBlock(p["norm"], SSD(*(p["ssd"][k] for k in SSD_KEYS)))
    if "rglru" in p:
        return RGLRUBlock(p["mix_norm"],
                          RGLRU(*(p["rglru"][k] for k in RGLRU_KEYS)),
                          p["ffn_norm"], _glu(p["ffn"]))
    if "cross" in p:
        return DecBlock(p["attn_norm"], p["cross_norm"], p["ffn_norm"],
                        _attn_from_tree(p["attn"]),
                        _attn_from_tree(p["cross"]), _glu(p["ffn"]))
    ffn = MoE(*(p["moe"][k] for k in MOE_KEYS)) if "moe" in p \
        else _glu(p["ffn"])
    return DenseBlock(p["attn_norm"], _attn_from_tree(p["attn"]),
                      p["ffn_norm"], ffn)


def _unstack(stacked: Dict[str, Any]) -> list:
    """The blocks of a layer-stacked tree, in order."""
    n = next(tree_tensors(stacked)).shape[0]
    return [block_from_tree(map_tree(lambda a, i=i: a[i], stacked))
            for i in range(n)]


def params_from_numpy(tree: Dict[str, Any], device="cuda",
                      dtype=torch.float32) -> DenseModel:
    """The JAX package's tree (numpy leaves) as the port's model: a
    ``DenseModel`` (a hybrid model's groups interleaved in execution
    order, then its tail) or a ``WhisperModel``."""
    t = tree_from_numpy(tree, device, dtype)
    head = (t["embed"], t["final_norm"])
    if "enc_blocks" in t:
        return WhisperModel(*head, _unstack(t["dec_blocks"]),
                            _unstack(t["enc_blocks"]), t["enc_norm"],
                            t.get("unembed"))
    if "groups" in t:
        groups = [_unstack(t["groups"][f"b{i}"])
                  for i in range(len(t["groups"]))]
        layers = [blk for row in zip(*groups) for blk in row]
        layers += _unstack(t["tail"]) if "tail" in t else []
        return DenseModel(*head, layers, t.get("unembed"),
                          groups=(len(groups[0]), len(groups)))
    return DenseModel(*head, _unstack(t["blocks"]), t.get("unembed"))


def tree_from_block(block) -> Dict[str, Any]:
    """One block as its per-layer tree (the inverse of
    ``block_from_tree``)."""
    if isinstance(block, SSDBlock):
        return {"norm": block.norm.detach(),
                "ssd": {k: getattr(block.ssd, k).detach()
                        for k in SSD_KEYS}}
    out = {k: getattr(block, k).detach() for k in _NORMS
           if hasattr(block, k)}
    for sub, keys in _BLOCK_KEYS.items():
        mod = getattr(block, sub, None)
        if mod is not None:
            out[sub] = {k: getattr(mod, k).detach() for k in keys
                        if hasattr(mod, k)}
    return out


def _stacked(blocks) -> Dict[str, Any]:
    return stack_layers([tree_from_block(b) for b in blocks])


def tree_from_params(params: DenseModel) -> Dict[str, Any]:
    """The model as the JAX package's stacked tree (block leaves stacked
    over the layers on their device): the layout
    ``runtime.paramstore.save_param_store`` and ``ResidentSource`` take
    (``groups``/``tail`` for a hybrid model, ``enc_blocks``/``enc_norm``/
    ``dec_blocks`` for whisper)."""
    out = {"embed": params.embed.detach(),
           "final_norm": params.final_norm.detach()}
    blocks = list(params.blocks)
    if isinstance(params, WhisperModel):
        out.update(enc_blocks=_stacked(params.enc_blocks),
                   enc_norm=params.enc_norm.detach(),
                   dec_blocks=_stacked(blocks))
    elif params.groups is not None:
        G, P = params.groups
        out["groups"] = {f"b{i}": _stacked(blocks[i:G * P:P])
                         for i in range(P)}
        if len(blocks) > G * P:
            out["tail"] = _stacked(blocks[G * P:])
    else:
        out["blocks"] = _stacked(blocks)
    if hasattr(params, "unembed"):
        out["unembed"] = params.unembed.detach()
    return out
