"""Grouped low-bit weight quantization of the port (``repro.quant.grouped``
in PyTorch).

Weights are quantized per group of ``group`` rows along the contraction
axis (axis -2 of a (..., K, N) weight), symmetric, one bf16 scale per
(group, column):

  q4: int4 in [-7, 7], two values per int8 byte: row 2i in the low
      nibble, row 2i+1 in the high nibble, packed (..., K/2, N).
  q2: int2 in [-1, 1], four values per byte (row 4i + j in bits 2j..2j+1),
      packed (..., K/4, N).

The packed bytes and the bf16 scale bits are identical to the JAX
package's: ``q`` is computed with the f32 scale (``amax / 7``, round half
to even, clip) and the scale is cast to bf16 afterwards. So a layer store
written by either package loads in the other (``runtime.paramstore``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

DEFAULT_GROUP = 64


@dataclasses.dataclass
class QuantizedTensor:
    """Packed quantized weight + per-group scales.

    ``packed``: int8 (..., K/2 [q4] or K/4 [q2], N); ``scale``: bf16
    (..., K/group, N); ``shape``: the unpacked (..., K, N).
    """

    packed: torch.Tensor
    scale: torch.Tensor
    bits: int
    group: int
    shape: Tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return self.packed.numel() * self.packed.element_size() \
            + self.scale.numel() * self.scale.element_size()

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "QuantizedTensor":
        """``fn`` applied to ``packed`` and ``scale``; the metadata stays
        (a leading-axis slice keeps ``shape``'s trailing (K, N))."""
        packed, scale = fn(self.packed), fn(self.scale)
        lead = tuple(packed.shape[:-2])
        return QuantizedTensor(packed, scale, self.bits, self.group,
                               lead + tuple(self.shape[-2:]))


def map_tree(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over every tensor of a nested-dict tree, a
    ``QuantizedTensor``'s packed and scale included (``jax.tree.map``)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.map(fn)
    return fn(tree)


def tree_tensors(tree: Any):
    """Every tensor of a nested-dict tree, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_tensors(tree[k])
    elif isinstance(tree, QuantizedTensor):
        yield tree.packed
        yield tree.scale
    else:
        yield tree


# --------------------------------------------------------------------------- #
#  int4
# --------------------------------------------------------------------------- #

def _group_scale(w: torch.Tensor, group: int, qmax: float):
    *lead, K, N = w.shape
    if K % group:
        raise ValueError(f"contraction dim {K} not a multiple of the group "
                         f"{group}")
    wg = w.float().reshape(*lead, K // group, group, N)
    amax = wg.abs().amax(dim=-2, keepdim=True)            # (..., K/g, 1, N)
    # divide by a tensor: on the card a Python-number divisor becomes a
    # multiply by its reciprocal, an ulp away from amax / 7 at times
    scale = torch.clamp(amax / amax.new_tensor(qmax), min=1e-8)
    q = torch.clamp(torch.round(wg / scale), -qmax, qmax).to(torch.int8)
    return q.reshape(*lead, K, N), scale[..., 0, :].to(torch.bfloat16)


def quantize_q4(w: torch.Tensor, group: int = DEFAULT_GROUP
                ) -> QuantizedTensor:
    """Symmetric int4 grouped quantization along axis -2 (contraction)."""
    q, scale = _group_scale(w, group, 7.0)
    return QuantizedTensor(packed=pack_q4(q), scale=scale, bits=4,
                           group=group, shape=tuple(w.shape))


def pack_q4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 in [-7, 7]) two per byte along axis -2."""
    lo = q[..., 0::2, :] & 0xF
    hi = q[..., 1::2, :] & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def unpack_q4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_q4``: (..., K/2, N) int8 -> (..., K, N) int8 in
    [-8, 7] (4-bit two's complement, sign-extended)."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    *lead, Kh, N = packed.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, Kh * 2, N)


def _dequantize(q: torch.Tensor, qt: QuantizedTensor, dtype
                ) -> torch.Tensor:
    # dims come from the packed array (a leading-axis slice of a stacked
    # bank keeps the trailing (K, N) of ``shape`` but not its lead)
    *lead, K, N = q.shape
    qg = q.float().reshape(*lead, K // qt.group, qt.group, N)
    w = qg * qt.scale[..., :, None, :].float()
    return w.reshape(*lead, K, N).to(dtype)


def dequantize_q4(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return _dequantize(unpack_q4(qt.packed), qt, dtype)


# --------------------------------------------------------------------------- #
#  int2
# --------------------------------------------------------------------------- #

def quantize_q2(w: torch.Tensor, group: int = DEFAULT_GROUP
                ) -> QuantizedTensor:
    if w.shape[-2] % 4:
        raise ValueError(f"q2 packs 4 rows a byte: K={w.shape[-2]}")
    q, scale = _group_scale(w, group, 1.0)
    return QuantizedTensor(packed=pack_q2(q), scale=scale, bits=2,
                           group=group, shape=tuple(w.shape))


def pack_q2(q: torch.Tensor) -> torch.Tensor:
    """Pack int2 values (int8 in [-2, 1]) four per byte along axis -2."""
    u = (q & 0x3).view(torch.uint8)
    out = u[..., 0::4, :]
    for i in range(1, 4):
        out = out | (u[..., i::4, :] << (2 * i))
    return out.view(torch.int8)


def unpack_q2(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_q2``: (..., K/4, N) int8 -> (..., K, N) int8 in
    [-2, 1]."""
    u = packed.view(torch.uint8)
    vals = []
    for i in range(4):
        v = ((u >> (2 * i)) & 0x3).to(torch.int8)
        vals.append(torch.where(v > 1, v - 4, v))
    *lead, Kq, N = packed.shape
    return torch.stack(vals, dim=-2).reshape(*lead, Kq * 4, N)


def dequantize_q2(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return _dequantize(unpack_q2(qt.packed), qt, dtype)


# --------------------------------------------------------------------------- #
#  trees
# --------------------------------------------------------------------------- #

def _is_weight(path: str, leaf: torch.Tensor, group: int, *,
               min_ndim: int = 2) -> bool:
    return (leaf.dim() >= min_ndim and leaf.shape[-2] % group == 0
            and leaf.shape[-1] >= 8 and "norm" not in path.lower())


def quantize_tree(params: Dict[str, Any], group: int = DEFAULT_GROUP,
                  bits: int = 4, *, stacked: bool = False) -> Dict[str, Any]:
    """Quantize every eligible matmul weight of a nested-dict tree.

    ``stacked=True`` for trees whose per-layer leaves carry a leading
    layer axis: it requires ndim >= 3, so a stacked (L, D) bias or norm is
    never read as a (K, N) weight when L happens to divide the group.
    """
    quant = quantize_q4 if bits == 4 else quantize_q2
    min_ndim = 3 if stacked else 2

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        if isinstance(tree, torch.Tensor) and _is_weight(
                prefix, tree, group, min_ndim=min_ndim):
            return quant(tree, group)
        return tree

    return walk(params, "")


def dequantize_leaf(leaf, dtype=torch.float32):
    if isinstance(leaf, QuantizedTensor):
        fn = dequantize_q4 if leaf.bits == 4 else dequantize_q2
        return fn(leaf, dtype)
    return leaf


def dequantize_tree(tree: Any, dtype=torch.float32) -> Any:
    """Dequantize every ``QuantizedTensor`` of a nested-dict tree; other
    leaves pass through untouched."""
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    return dequantize_leaf(tree, dtype)
