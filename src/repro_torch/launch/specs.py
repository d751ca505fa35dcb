"""Shape-and-dtype stand-ins for every (arch x shape x step) cell:
``repro.launch.specs`` on PyTorch's ``meta`` device.

Params, optimizer state, caches and batches are trees of meta tensors in
the JAX package's layouts (its stacked parameter tree, ``AdamState``,
``init_cache``'s dict): shapes and dtypes, no storage, so a 70B
configuration costs nothing to describe. They are built by running the
port's own builders on the meta device (``init_params``, ``init_cache``,
``runtime.serve.pad_vocab``, ``pad_and_permute`` and
``quantize_ring_params``): every op they use has a meta kernel, so no
shape is derived by a rule of its own here. The JAX package's
``jax.eval_shape`` plays the same part there. The dry run
(``launch.dryrun``) is their user: it cuts them to a rank's part and
runs the rank's step on them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import bridge
from ..configs import get_config
from ..configs.base import SHAPES, ModelConfig, ShapeSpec
from ..models import model as M
from ..runtime import serve
from ..runtime.optim import AdamState

META = torch.device("meta")


def decode_context(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Decode context, bounded by the arch's own window and limits."""
    S = shape.seq_len
    if cfg.attn_window:
        S = min(S, cfg.attn_window) if cfg.family != "hybrid" else S
    if cfg.max_decode_len:
        S = min(S, cfg.max_decode_len)
    return S


def params_shapes(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The stacked parameter tree (``bridge.tree_from_params``)."""
    return bridge.tree_from_params(
        M.init_params(cfg, None, dtype=dtype, device=META))


def ring_params_shapes(cfg: ModelConfig, n_stages: int, k: int, tp: int,
                       dtype=torch.bfloat16, quant: int = 0
                       ) -> Dict[str, Any]:
    """The ring's parameter tree: vocab padded to ``tp``, blocks padded
    and permuted for ``n_stages`` stages of ``k`` rounds, q4 leaves
    (``QuantizedTensor`` of meta tensors) with ``quant``."""
    p = serve.pad_vocab(params_shapes(cfg, dtype), cfg, tp)
    p["blocks"] = serve.pad_and_permute(p["blocks"], cfg, n_stages, k)
    if quant:
        p, _skipped = serve.quantize_ring_params(p, cfg, tp=tp)
    return p


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16, *,
                 ring: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    c = M.init_cache(cfg, batch, max_len, dtype=dtype, device=META)
    if ring is not None:
        n_stages, k = ring
        c["layers"] = serve.pad_and_permute(c["layers"], cfg, n_stages, k)
    return c


def _meta_like(t: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.empty(t.shape, dtype=dtype or t.dtype, device=META)


def opt_shapes(params_like: Dict[str, Any]) -> AdamState:
    """``AdamState`` over a parameter tree: an int32 step and f32
    moments shaped like every leaf."""
    def moments(tree):
        if isinstance(tree, dict):
            return {k: moments(v) for k, v in tree.items()}
        return _meta_like(tree, torch.float32)
    return AdamState(step=torch.empty((), dtype=torch.int32, device=META),
                     mu=moments(params_like), nu=moments(params_like))


def batch_shapes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model inputs for one cell (excluding params/cache/opt)."""
    B, S = shape.global_batch, shape.seq_len

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    if shape.kind in ("train", "prefill"):
        out = {"tokens": sd((B, S), torch.int32)}
        if shape.kind == "train":
            out["labels"] = sd((B, S), torch.int32)
        if cfg.frontend:
            out["embeds"] = sd((B, cfg.n_frontend_tokens, cfg.d_model),
                               torch.bfloat16)
        return out
    # decode: one new token against a seq_len context
    return {"tokens": sd((B, 1), torch.int32), "ln": sd((B,), torch.int32)}


def input_specs(arch_or_cfg, shape_name: str) -> Dict[str, Any]:
    """The full set for a cell: params, batch and (not training) the
    cache at ``decode_context``."""
    cfg = (arch_or_cfg if isinstance(arch_or_cfg, ModelConfig)
           else get_config(arch_or_cfg))
    shape = SHAPES[shape_name]
    out = {"batch": batch_shapes(cfg, shape), "params": params_shapes(cfg)}
    if shape.kind != "train":
        ctx = decode_context(cfg, shape)
        out["cache"] = cache_shapes(cfg, shape.global_batch, ctx)
    return out
