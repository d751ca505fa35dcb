"""Partition specs of the port (``repro.runtime.sharding``, without
``jax.sharding``).

A mesh is an ordered ``{axis: size}`` (``{"pod": 2, "data": 16, "model":
16}``); a spec is a plain tuple with one entry a dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the dimension split
over their product, the first axis major). The rules are the JAX
package's, leaf by leaf:

  "pod"   : data-parallel replicas across pods (multi-pod only)
  "data"  : FSDP / batch axis within a pod
  "model" : tensor-parallel axis

  * column-parallel weights (d -> heads*hd / d_ff): (L, d, out) ->
    (None, "data", "model");
  * row-parallel weights (heads*hd / d_ff -> d): (L, in, d) ->
    (None, "model", "data");
  * MoE experts: expert-parallel over "model" when E % tp == 0 (or as
    ``set_moe_ep`` forces), else TP inside each expert on the f dim;
  * embeddings: vocab over "model", d over "data";
  * norms, small vectors: replicated.

``sanitize`` drops an axis whose size does not divide the dimension, as
the JAX package does before it builds a ``NamedSharding``. A tree's leaves
are named by their path in ``jax.tree_util.keystr``'s form
(``['blocks']['attn']['wq']``; a packed q4 leaf's ``packed`` and ``scale``
carry its key), in the order ``jax.tree_util`` flattens a dict (sorted
keys), so specs compare with the JAX package's leaf by leaf.

``local_shard`` cuts one rank's part of a full tensor from its spec and
its mesh coordinates; ``assemble`` puts the parts back together (the
tests' inverse). The ring across ranks (``runtime.serve``) shards its
parameters and cache with them.
"""
from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..quant.grouped import QuantizedTensor

Mesh = Mapping[str, int]
Spec = Tuple[Any, ...]

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "wq_b", "wk_b", "wv_b",
        "w_x", "w_y", "w_z", "w_b", "w_c", "w_dt", "in_proj"}
_ROW = {"wo", "w_down", "w_out", "out_proj"}
_LATENT = {"wq_a", "wkv_a"}


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec over a mesh (the port's ``NamedSharding``)."""
    mesh: Tuple[Tuple[str, int], ...]
    spec: Spec


def _sharding(mesh: Mesh, spec: Spec) -> Sharding:
    return Sharding(tuple(mesh.items()), tuple(spec))


# --------------------------------------------------------------------------- #
#  trees
# --------------------------------------------------------------------------- #

def flatten_with_path(tree: Any, prefix: str = ""
                      ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) over a nested dict in ``jax.tree_util`` order (sorted
    keys); a ``QuantizedTensor`` yields its packed bytes and its scale
    under ``<path>.packed`` and ``<path>.scale``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_path(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, QuantizedTensor):
        yield f"{prefix}.packed", tree.packed
        yield f"{prefix}.scale", tree.scale
    elif tree is not None:
        yield prefix, tree


def leaf_key(path: str) -> str:
    keys = re.findall(r"\['([^']+)'\]", path)
    return keys[-1] if keys else path


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def axis_size(mesh: Mesh, entry) -> int:
    n = 1
    for a in _axes(entry):
        n *= mesh[a]
    return n


def sanitize(spec: Spec, shape, mesh: Mesh) -> Spec:
    """Drop spec axes whose mesh size does not divide the dimension (a
    tuple entry keeps its longest prefix that does). The result has
    exactly ``len(shape)`` entries."""
    padded = (tuple(spec) + (None,) * len(shape))[:len(shape)]
    out: List[Any] = []
    for i, axis in enumerate(padded):
        if axis is None:
            out.append(None)
        elif shape[i] % axis_size(mesh, axis) == 0:
            out.append(axis)
        elif isinstance(axis, (tuple, list)):
            kept = None
            for j in range(len(axis) - 1, 0, -1):
                if shape[i] % axis_size(mesh, axis[:j]) == 0:
                    kept = tuple(axis[:j])
                    break
            out.append(kept)
        else:
            out.append(None)
    return tuple(out)


# --------------------------------------------------------------------------- #
#  the rules
# --------------------------------------------------------------------------- #

def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes of the batch dimension (pods fold into data-parallel)."""
    return ("pod", "data") if "pod" in mesh else ("data",)


#: experiment override for MoE expert-parallelism (None: by divisibility)
_MOE_EP_OVERRIDE: Optional[bool] = None


def set_moe_ep(value: Optional[bool]) -> None:
    global _MOE_EP_OVERRIDE
    _MOE_EP_OVERRIDE = value


def moe_ep(cfg: ModelConfig, mesh: Mesh) -> bool:
    tp = mesh["model"]
    if _MOE_EP_OVERRIDE is not None:
        return _MOE_EP_OVERRIDE and cfg.n_experts > 0 \
            and cfg.n_experts % tp == 0
    return cfg.n_experts > 0 and cfg.n_experts % tp == 0


def param_spec(cfg: ModelConfig, mesh: Mesh, path: str, leaf_ndim: int,
               style: str = "fsdp") -> Spec:
    """The spec of one parameter leaf. ``fsdp``: weights over "data" and
    "model"; ``zero1``: the same with "data" dropped (the optimizer
    moments take it, ``zero1_moment_shardings``)."""
    if style == "zero1":
        spec = param_spec(cfg, mesh, path, leaf_ndim, style="fsdp")
        return tuple(None if ax == "data" else ax for ax in spec)
    key = leaf_key(path)
    ep = moe_ep(cfg, mesh)
    if key == "embed":
        return ("model", "data")
    if key == "unembed":
        return ("data", "model")
    if leaf_ndim == 4 and key in ("w_gate", "w_up"):     # (L, E, d, f)
        return (None, "model", "data", None) if ep \
            else (None, None, "data", "model")
    if leaf_ndim == 4 and key == "w_down":               # (L, E, f, d)
        return (None, "model", None, "data") if ep \
            else (None, None, "model", "data")
    if key == "router":
        return (None, "data", None)
    if key in _ROW:
        return (None, "model", "data") if leaf_ndim == 3 \
            else ("model", "data")
    if key in _COL:
        return (None, "data", "model") if leaf_ndim == 3 \
            else ("data", "model")
    if key in _LATENT:
        return (None, "data", None)
    return ()


def param_shardings(cfg: ModelConfig, mesh: Mesh, params: Any,
                    style: str = "fsdp") -> Dict[str, Sharding]:
    """{path: Sharding} of every leaf of ``params``, sanitized."""
    out = {}
    for path, leaf in flatten_with_path(params):
        shape = _shape(leaf)
        spec = param_spec(cfg, mesh, path, len(shape), style=style)
        out[path] = _sharding(mesh, sanitize(spec, shape, mesh))
    return out


def zero1_moment_shardings(cfg: ModelConfig, mesh: Mesh, params: Any
                           ) -> Dict[str, Sharding]:
    """ZeRO-1 optimizer-state shardings: the param's TP spec plus "data"
    on the first still-unsharded axis it divides."""
    out = {}
    d = mesh["data"]
    for path, leaf in flatten_with_path(params):
        shape = _shape(leaf)
        spec = list(sanitize(param_spec(cfg, mesh, path, len(shape),
                                        style="zero1"), shape, mesh))
        for i, n in enumerate(shape):
            if spec[i] is None and n % d == 0:
                spec[i] = "data"
                break
        out[path] = _sharding(mesh, tuple(spec))
    return out


def cache_spec(cfg: ModelConfig, mesh: Mesh, path: str, shape) -> Spec:
    """KV/state cache specs of the GSPMD decode: batch over the data
    axes; "model" on the kv-head dim where it divides, else the sequence
    dim, else replicated over "model"."""
    b = batch_axes(mesh)
    tp = mesh["model"]
    key = leaf_key(path)
    nd = len(shape)
    if key == "len":
        return ()
    if key == "latent":                      # (L, B, S, r) -- MLA
        return (None, b, "model" if shape[2] % tp == 0 else None, None)
    if key == "state":                       # (L, B, nh, P, N)
        return (None, b, "model" if shape[2] % tp == 0 else None, None,
                None)
    if key == "conv":                        # (L, B, K-1, C)
        return (None, b, None, "model" if shape[3] % tp == 0 else None)
    if key == "h":                           # (G, B, w)
        return (None, b, "model" if shape[2] % tp == 0 else None)
    if key in ("cross_k", "cross_v"):        # (L, B, F, hk, hd)
        return (None, b, None, None, None)
    if nd == 5:                              # k/v (L, B, S, hk, hd)
        if shape[3] % tp == 0:
            return (None, b, None, "model", None)
        if shape[2] % tp == 0:
            return (None, b, "model", None, None)
        return (None, b, None, None, None)
    if nd == 4:                              # int8 scales (L, B, S, hk)
        if shape[3] % tp == 0:
            return (None, b, None, "model")
        if shape[2] % tp == 0:
            return (None, b, "model", None)
        return (None, b, None, None)
    return ()


def cache_shardings(cfg: ModelConfig, mesh: Mesh, cache: Any
                    ) -> Dict[str, Sharding]:
    out = {}
    for path, leaf in flatten_with_path(cache):
        shape = _shape(leaf)
        out[path] = _sharding(mesh, sanitize(
            cache_spec(cfg, mesh, path, shape), shape, mesh))
    return out


def data_sharding(mesh: Mesh, ndim: int, *, mrope: bool = False
                  ) -> Sharding:
    """Tokens/labels (B, S): batch over pod+data. M-RoPE positions are
    (3, B, S), the batch on axis 1."""
    b = batch_axes(mesh)
    if mrope and ndim == 3:
        return _sharding(mesh, (None, b, None))
    return _sharding(mesh, (b,) + (None,) * (ndim - 1))


def embeds_sharding(mesh: Mesh) -> Sharding:
    """Frontend embeddings (B, F, d)."""
    return _sharding(mesh, (batch_axes(mesh), None, None))


def replicated(mesh: Mesh) -> Sharding:
    return _sharding(mesh, ())


# --------------------------------------------------------------------------- #
#  a rank's part
# --------------------------------------------------------------------------- #

def shard_index(entry, mesh: Mesh, coords: Mapping[str, int]) -> int:
    """The index of the part ``coords`` holds along a dimension split by
    ``entry`` (a tuple: the first axis major)."""
    idx = 0
    for a in _axes(entry):
        idx = idx * mesh[a] + coords[a]
    return idx


def local_shard(t: torch.Tensor, spec: Spec, mesh: Mesh,
                coords: Mapping[str, int]) -> torch.Tensor:
    """The part of ``t`` the rank at ``coords`` (``{axis: index}``) holds
    under ``spec``: a view of ``t`` (``narrow`` on each split dimension).
    Raises where a split does not divide its dimension (``sanitize``
    first)."""
    spec = (tuple(spec) + (None,) * t.dim())[:t.dim()]
    for dim, entry in enumerate(spec):
        n = axis_size(mesh, entry)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {entry} ({n})")
        size = t.shape[dim] // n
        t = t.narrow(dim, shard_index(entry, mesh, coords) * size, size)
    return t


def mesh_coords(mesh: Mesh) -> Iterator[Dict[str, int]]:
    """Every coordinate of ``mesh``, the first axis major."""
    names = list(mesh)
    for idx in itertools.product(*(range(mesh[a]) for a in names)):
        yield dict(zip(names, idx))


def assemble(parts: Mapping[Tuple[int, ...], torch.Tensor], spec: Spec,
             mesh: Mesh) -> torch.Tensor:
    """``local_shard``'s inverse: the full tensor from every coordinate's
    part (``parts[tuple of indices in mesh order]``). Raises where two
    replicas of one part differ."""
    names = list(mesh)
    first = next(iter(parts.values()))
    spec = (tuple(spec) + (None,) * first.dim())[:first.dim()]
    shape = [s * axis_size(mesh, e) for s, e in zip(first.shape, spec)]
    out = first.new_empty(shape)
    seen: Dict[Tuple[int, ...], torch.Tensor] = {}
    for coords in mesh_coords(mesh):
        part = parts[tuple(coords[a] for a in names)]
        at = tuple(shard_index(e, mesh, coords) for e in spec)
        if at in seen:
            if not torch.equal(seen[at], part):
                raise ValueError(f"replicas of part {at} differ")
            continue
        seen[at] = part
        view = out
        for dim, (i, n) in enumerate(zip(at, part.shape)):
            view = view.narrow(dim, i * n, n)
        view.copy_(part)
    return out
