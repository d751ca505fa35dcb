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

from typing import Any, Dict, List

import numpy as np
import torch

from .models.model import (GLU, MLA, MLA_KEYS, MOE_KEYS, RGLRU, RGLRU_KEYS,
                           SSD, SSD_KEYS, Attention, DecBlock, DenseBlock,
                           DenseModel, MoE, RGLRUBlock, SSDBlock,
                           WhisperModel)
from .quant.grouped import QuantizedTensor, map_tree, tree_tensors

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


def _detached(t: torch.Tensor) -> torch.Tensor:
    return t.detach()


def tree_from_block(block, leaf=_detached) -> Dict[str, Any]:
    """One block as its per-layer tree (the inverse of
    ``block_from_tree``), each parameter ``t`` as ``leaf(t)``."""
    if isinstance(block, SSDBlock):
        return {"norm": leaf(block.norm),
                "ssd": {k: leaf(getattr(block.ssd, k)) for k in SSD_KEYS}}
    out = {k: leaf(getattr(block, k)) for k in _NORMS
           if hasattr(block, k)}
    for sub, keys in _BLOCK_KEYS.items():
        mod = getattr(block, sub, None)
        if mod is not None:
            out[sub] = {k: leaf(getattr(mod, k)) for k in keys
                        if hasattr(mod, k)}
    return out


def _merge(trees: List[Any], stack) -> Any:
    """Per-layer trees merged leaf by leaf: ``stack`` of each leaf's
    list over the layers."""
    if isinstance(trees[0], dict):
        return {k: _merge([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)


def tree_from_params(params: DenseModel, leaf=_detached,
                     stack=torch.stack) -> Dict[str, Any]:
    """The model as the JAX package's stacked tree (block leaves stacked
    over the layers on their device): the layout
    ``runtime.paramstore.save_param_store`` and ``ResidentSource`` take
    (``groups``/``tail`` for a hybrid model, ``enc_blocks``/``enc_norm``/
    ``dec_blocks`` for whisper). Each parameter ``t`` enters as
    ``leaf(t)`` (a gradient, a moment, a copy on the host), and a block
    leaf's list over the layers as ``stack(list)``."""
    def stacked(blocks):
        return _merge([tree_from_block(b, leaf) for b in blocks], stack)

    out = {"embed": leaf(params.embed),
           "final_norm": leaf(params.final_norm)}
    blocks = list(params.blocks)
    if isinstance(params, WhisperModel):
        out.update(enc_blocks=stacked(params.enc_blocks),
                   enc_norm=leaf(params.enc_norm),
                   dec_blocks=stacked(blocks))
    elif params.groups is not None:
        G, P = params.groups
        out["groups"] = {f"b{i}": stacked(blocks[i:G * P:P])
                         for i in range(P)}
        if len(blocks) > G * P:
            out["tail"] = stacked(blocks[G * P:])
    else:
        out["blocks"] = stacked(blocks)
    if hasattr(params, "unembed"):
        out["unembed"] = leaf(params.unembed)
    return out


# --------------------------------------------------------------------------- #
#  training state: gradients, AdamW moments, checkpoints
# --------------------------------------------------------------------------- #

def _slots(params: DenseModel) -> Dict[str, Any]:
    """The JAX tree with the model's parameters in place of its leaves: a
    block leaf is the list of its layers' parameters."""
    return tree_from_params(params, leaf=lambda t: t, stack=list)


def _pairs(slots: Any, tree: Any):
    """(parameter, its array in ``tree``) for every parameter, a block
    leaf's row ``i`` for layer ``i``."""
    if isinstance(slots, dict):
        for k in slots:
            yield from _pairs(slots[k], tree[k])
    elif isinstance(slots, list):
        for i, p in enumerate(slots):
            yield p, tree[i]
    else:
        yield slots, tree


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return _bf16(a)
    return torch.from_numpy(np.array(a))


def leaves_from_tree(params: DenseModel, tree: Dict[str, Any]
                     ) -> List[torch.Tensor]:
    """A JAX-shaped tree (numpy or torch leaves, e.g. a gradient or a
    moment tree) as one tensor for each of ``params.parameters()``, in
    that order, each on its parameter's device in the tree's dtype."""
    by_id = {id(p): _as_tensor(a).to(p.device)
             for p, a in _pairs(_slots(params), tree)}
    return [by_id[id(p)] for p in params.parameters()]


@torch.no_grad()
def load_params_tree(params: DenseModel, tree: Dict[str, Any]) -> None:
    """Copy a JAX-shaped tree (numpy or torch leaves) into the model's
    parameters in place, cast to each parameter's dtype."""
    for p, a in _pairs(_slots(params), tree):
        p.copy_(_as_tensor(a))


def tree_of_leaves(params: DenseModel, leaves) -> Dict[str, Any]:
    """One tensor for each of ``params.parameters()`` (a gradient, a
    moment) as the JAX-shaped tree, stacked where the leaves are."""
    by_id = {id(p): t for p, t in zip(params.parameters(), leaves)}
    return tree_from_params(params, leaf=lambda p: by_id[id(p)].detach())


def grads_tree(params: DenseModel) -> Dict[str, Any]:
    """The parameters' ``.grad`` as the JAX-shaped gradient tree (a zero
    where a parameter got no gradient)."""
    return tree_of_leaves(params, [torch.zeros_like(p) if p.grad is None
                                   else p.grad
                                   for p in params.parameters()])


def opt_state_tree(params: DenseModel, state):
    """The port's ``AdamState`` (step, one moment for each parameter) as
    the JAX ``AdamState`` layout: (step, mu tree, nu tree), in the port's
    ``AdamState`` NamedTuple."""
    return type(state)(step=state.step,
                       mu=tree_of_leaves(params, state.mu),
                       nu=tree_of_leaves(params, state.nu))


def opt_state_from_tree(params: DenseModel, tree, state_type):
    """A JAX ``AdamState`` (or its checkpointed tree: step, mu tree, nu
    tree) as the port's ``state_type`` over ``params``: f32 moments on
    each parameter's device, the step an int32 scalar."""
    step, mu, nu = tree
    dev = next(params.parameters()).device
    return state_type(
        step=_as_tensor(step).to(device=dev, dtype=torch.int32).reshape(()),
        mu=[t.float() for t in leaves_from_tree(params, mu)],
        nu=[t.float() for t in leaves_from_tree(params, nu)])
