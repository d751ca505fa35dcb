"""The piped ring (PRP) of the port: its layout, its serve step, and the
packed-int4 layer bank (``repro.runtime.serve``'s ring, in PyTorch).

Mapping: the model's (padded) L layers split into k*M windows of w
layers; stage m owns windows {r*M + m : r < k}, stored stage-major as one
block of k*w ring rows (``ring_permutation``). All M stages run in one
process on one device (``launch.mesh.RingLayout``): each stage has its
own k*w rows of the layer bank and of the cache, and the ring hop is a
hand-off of a stage's output to the next stage. Tensor parallelism inside
a stage (the JAX package's "model" axis) runs across ranks (the second
half of this module: ``RankRingStep``, its parts resident or streamed),
so in one process the sequence-split attention merge, the vocab-sharded
embed and unembed and the split FFN are their tp = 1 identities.

Decode schedule (one pass, T tokens for the whole batch): the batch
splits into M microbatches; at microstep t, stage m takes microbatch
e = (t - m) mod M through window r = (t - e) // M of its rows, and its
output becomes stage m+1's input; after k*M + M - 1 microsteps every
microbatch has crossed all layers, its final hiddens are normed where
j = t - e is the last window, and the whole batch is unembedded. The JAX
step computes out-of-schedule (stage, microstep) pairs and masks them;
the port skips them (the result is the same). Stages run in stage order
on one stream.

Every ring layer's attention is ``layers.attn_block``'s decode over its
stage's cache slice: kernel B5 (``kernels.flash_decode.flash_verify``) on
the card, the int8 cache read as stored, and its plain version on the CPU
(the JAX ring's stats merged over a tensor-parallel group of one); an MLA
layer's is ``layers.mla_block``'s absorbed decode over its latent lines,
plain torch as in the JAX ring's ``_ring_mla_layer``. Every projection
goes through ``layers.qmm`` (kernel B3 for a packed q4 ring bank; MLA's
``wq_a``, ``wq_b`` and ``wkv_a`` too, where the layer-wise path
dequantizes them).
Cache and length
writes are in place. ``RingServeStep`` replays the step from CUDA graphs
on the card (``runtime.engine.StepGraphs``) unless ``graphs=False``.

The serve driver also quantizes the layer store with
``quantize_ring_params`` at ``tp=1``.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import layers as ll
from ..quant.grouped import (QuantizedTensor, dequantize_leaf, map_tree,
                             quantize_q4, tree_tensors)
from .telemetry import clock, resolve_tracer

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
#  ring layout: permutation, padding
# --------------------------------------------------------------------------- #

def ring_supported(cfg: ModelConfig, batch: int, n_stages: int) -> bool:
    """Ring decode needs a uniform layer stack (dense GQA or MLA, moe,
    vlm or ssm) and the same number of sequences on every stage."""
    return (cfg.family in ("dense", "moe", "vlm", "ssm")
            and n_stages >= 1 and batch % n_stages == 0)


def padded_layers(L: int, n_stages: int) -> int:
    return -(-L // n_stages) * n_stages


def ring_permutation(L_pad: int, n_stages: int, k: int) -> np.ndarray:
    """perm[i] = global layer index stored at ring-stacked position i.

    Position layout: stage-major, then round, then offset-in-window:
    stage m's contiguous block of k*w rows holds its k windows in order.
    """
    assert L_pad % (n_stages * k) == 0, (L_pad, n_stages, k)
    w = L_pad // (n_stages * k)
    perm = np.zeros(L_pad, dtype=np.int64)
    i = 0
    for m in range(n_stages):
        for r in range(k):
            base = (r * n_stages + m) * w
            for off in range(w):
                perm[i] = base + off
                i += 1
    return perm


def pad_and_permute(stacked: Any, cfg: ModelConfig, n_stages: int, k: int
                    ) -> Any:
    """Zero-pad the layer axis to ``RingPlan.make``'s L_pad (identity
    residual blocks) and apply the ring permutation, as new tensors (zero
    rows, then ``index_select`` on dim 0). Works on a stacked block tree
    (``bridge.tree_from_params(...)["blocks"]``, q4 leaves included) or
    on ``init_cache``'s ``layers``."""
    L = cfg.n_layers
    L_pad = padded_layers(L, n_stages * k)     # RingPlan.make's
    perm = ring_permutation(L_pad, n_stages, k)

    def fix(a: torch.Tensor) -> torch.Tensor:
        if a.shape[0] != L:
            return a
        if L_pad != L:
            a = torch.cat([a, a.new_zeros((L_pad - L,) + tuple(a.shape[1:]))])
        return a.index_select(0, torch.as_tensor(perm, device=a.device))

    return map_tree(fix, stacked)


def pad_vocab(params: Params, cfg: ModelConfig, tp: int) -> Params:
    """Pad embed/unembed vocab to a multiple of tp (the vocab-sharded
    head's divisibility; the logits' padded columns are cut by the
    caller)."""
    V = cfg.vocab
    V_pad = -(-V // tp) * tp
    if V_pad == V:
        return params
    out = dict(params)
    out["embed"] = torch.nn.functional.pad(params["embed"],
                                           (0, 0, 0, V_pad - V))
    if "unembed" in params:
        out["unembed"] = torch.nn.functional.pad(params["unembed"],
                                                 (0, V_pad - V))
    return out


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


#: per-layer leaves the ring window consumes through ``layers.qmm``: a 2-D
#: q4 slice of these stays packed and goes to kernel B3
_RING_QMM_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "wq_a", "wq_b", "wkv_a", "in_proj", "out_proj"})


def dequant_ring_reference(blocks, dtype=torch.float32):
    """Dequantize a *stacked* ring layer bank with the numerics the window
    applies at use: leaves consumed through ``layers.qmm``, the q4 expert
    stacks (B3 multiplies int4 by the scale in f32) and a moe router keep
    full precision, everything else dequantizes through bf16 as
    ``_prep_ring_layer`` does."""
    def walk(tree, experts=False):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if isinstance(v, QuantizedTensor):
                    keep = (k in _RING_QMM_KEYS and v.bits == 4
                            and v.packed.dim() == 3 + experts) \
                        or k == "router"
                    dq = dequantize_leaf(
                        v, torch.float32 if keep else torch.bfloat16)
                    out[k] = dq.to(dtype)
                else:
                    out[k] = walk(v, k == "moe")
            return out
        return tree

    return walk(blocks)


def _prep_ring_layer(p):
    """One ring layer's tree for the window: 2-D q4 leaves consumed via
    ``layers.qmm`` stay packed (B3 dequantizes them tile by tile), and so
    do the q4 expert stacks (``layers.expert_mm``: B3 once an expert,
    where the JAX ring dequantizes them to bf16 first). A q4 moe router
    dequantizes to f32, as the layer-wise path dequantizes it (the JAX
    ring rounds it to bf16): its logits pick the experts, so the ring
    routes as the one-device decode does. Any other quantized leaf
    dequantizes to bf16 up front, as in the JAX package."""
    def walk(tree, experts=False):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if isinstance(v, QuantizedTensor):
                    keep = (k in _RING_QMM_KEYS and v.bits == 4
                            and v.packed.dim() == 2 + experts)
                    out[k] = v if keep else dequantize_leaf(
                        v, torch.float32 if k == "router" else torch.bfloat16)
                else:
                    out[k] = walk(v, k == "moe")
            return out
        return tree

    return walk(p)


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """Static ring decode plan (the Halda decision for this layout)."""
    n_stages: int
    k: int                      # rounds per token
    w: int                      # layers per window
    L_pad: int

    @classmethod
    def make(cls, cfg: ModelConfig, n_stages: int, k: int = 1) -> "RingPlan":
        """The plan of ``n_stages`` stages and ``k`` rounds: the JAX
        package's where ``k`` divides a stage's layers (which it
        requires); otherwise the stack pads on with zero layers to the
        next multiple of ``n_stages * k`` (a 4-layer model on 4 stages at
        k = 2 runs 4 zero layers)."""
        if n_stages < 1 or k < 1:
            raise ValueError(f"a ring needs n_stages >= 1 and k >= 1 (got "
                             f"{n_stages}, {k})")
        L_pad = padded_layers(cfg.n_layers, n_stages * k)
        return cls(n_stages=n_stages, k=k, w=L_pad // (n_stages * k),
                   L_pad=L_pad)

    @property
    def n_steps(self) -> int:
        """Microsteps of one pass: k*M + M - 1."""
        return self.k * self.n_stages + self.n_stages - 1


def ring_bank_rounds(plan: RingPlan, t: int) -> np.ndarray:
    """(M,) round index r_m(t) stage m computes at microstep t (clipped
    for out-of-schedule stages)."""
    M_stages, k = plan.n_stages, plan.k
    out = np.zeros(M_stages, dtype=np.int64)
    for m in range(M_stages):
        e = (t - m) % M_stages
        j = t - e
        out[m] = min(max(j // M_stages, 0), k - 1)
    return out


def ring_bank_layers(plan: RingPlan, t: int) -> np.ndarray:
    """(M*w,) global layer index for each row of the step-t window bank.

    Bank row m*w + off is ring-stacked position m*k*w + r_m(t)*w + off,
    i.e. global layer (r_m(t)*M + m)*w + off (rows >= L are zero padding).
    """
    M_stages, k, w = plan.n_stages, plan.k, plan.w
    rs = ring_bank_rounds(plan, t)
    rows = np.zeros(M_stages * w, dtype=np.int64)
    for m in range(M_stages):
        for off in range(w):
            rows[m * w + off] = (rs[m] * M_stages + m) * w + off
    return rows


def layer_trees(params) -> List[Params]:
    """The per-layer block trees of a ``DenseModel`` or of a stacked tree
    (``{"blocks": ...}``), as views of its tensors."""
    from ..bridge import tree_from_block

    if isinstance(params, dict):
        blocks = params["blocks"]
        n = next(tree_tensors(blocks)).shape[0]
        return [map_tree(lambda a, i=i: a[i], blocks) for i in range(n)]
    return [tree_from_block(b) for b in params.blocks]


def _head(params) -> Params:
    if isinstance(params, dict):
        return {k: v for k, v in params.items() if k != "blocks"}
    out = {"embed": params.embed.detach(),
           "final_norm": params.final_norm.detach()}
    if hasattr(params, "unembed"):
        out["unembed"] = params.unembed.detach()
    return out


def ring_params(params, cfg: ModelConfig, plan: RingPlan,
                tp: int = 1) -> Params:
    """The ring's parameters: the head (``embed``, ``final_norm``[,
    ``unembed``], the vocab padded to a multiple of ``tp``) and ``blocks``, the L_pad layer blocks in ring order
    (``pad_and_permute``'s order) built over views of ``params`` (a
    ``DenseModel`` or a stacked tree, q4 leaves included), so the ring
    holds no second copy of the weights; padding rows share one zero
    block (an identity residual)."""
    from ..bridge import block_from_tree

    trees = layer_trees(params)
    perm = ring_permutation(plan.L_pad, plan.n_stages, plan.k)
    zero = None
    blocks = []
    for i in perm:
        if i < cfg.n_layers:
            tree = trees[i]
        else:
            if zero is None:
                zero = map_tree(torch.zeros_like, trees[0])
            tree = zero
        blocks.append(block_from_tree(_prep_ring_layer(tree)))
    return dict(pad_vocab(_head(params), cfg, tp), blocks=blocks)


# --------------------------------------------------------------------------- #
#  per-family ring window layers (decode)
# --------------------------------------------------------------------------- #

def _ring_attn_layer(cfg: ModelConfig, p, x, c, ln):
    """One dense, moe or vlm decoder layer, ring decode mode:
    ``attn_block``'s decode (B5 on the card) over the stage's cache slice,
    or an MLA layer's ``mla_block`` absorbed decode over its latent lines.
    x: (mb, T, d) (T = 1 decode, T > 1 the speculative verify block); c:
    the stage's cache slice {k/v: (mb, S, hk, hd)[, scales]} or {latent:
    (mb, S, r_kv + dr)}, written in place; ln: (mb,) tokens so far."""
    from ..models.model import default_positions

    pos = default_positions(cfg, x.shape[0], x.shape[1], ln)
    h = ll.rms_norm(x, p.attn_norm, cfg.norm_eps)
    block = ll.mla_block if cfg.mla else ll.attn_block
    o, _ = block(p.attn, cfg, h, pos, cache={**c, "len": ln}, decode=True)
    x = x + o
    g = ll.rms_norm(x, p.ffn_norm, cfg.norm_eps)
    return x + ll.block_ffn(p, cfg, g, lossless=True)


def _ring_ssd_layer(cfg: ModelConfig, p, x, c, ln):
    """SSM ring decode: the recurrence's one step, state in place."""
    h = ll.rms_norm(x, p.norm, cfg.norm_eps)
    return x + ll.ssd_block(p.ssd, cfg, h, cache=c, decode=True)


def run_ring_window(cfg: ModelConfig, blocks: Sequence, x, layers: Dict,
                    rows: Sequence[int], batch: slice, ln):
    """Apply one window: ``blocks[i]`` over cache row ``rows[i]`` of every
    leaf of ``layers`` (the ring-ordered cache's ``layers``), batch rows
    ``batch``."""
    layer = _ring_ssd_layer if cfg.family == "ssm" else _ring_attn_layer
    for blk, row in zip(blocks, rows):
        c = {name: a[row, batch] for name, a in layers.items()}
        x = layer(cfg, blk, x, c, ln)
    return x


def _ring_embed(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) -> (B, T, d) (the whole vocab on the one stage group
    of tp = 1)."""
    return embed[tokens.long()]


def _ring_unembed(head: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, d) -> logits (B, T, V)."""
    if "unembed" in head:
        return x @ head["unembed"]
    return x @ head["embed"].T


def ring_pass(cfg: ModelConfig, plan: RingPlan, head: Params,
              window: Callable, cache: Dict, tokens: torch.Tensor, *,
              on_step: Optional[Callable] = None, tracer=None
              ) -> Tuple[torch.Tensor, Dict]:
    """One ring pass over ``tokens`` (B, T): the k*M + M - 1 microsteps.

    ``window(t, m, r)`` returns stage m's blocks for round r at microstep
    t (the resident bank's rows, or the streamed bank's). ``on_step(t)``
    runs after microstep t (the streamed bank's release). With a
    ``tracer`` each microstep, the embed and the head are phases on the
    ``ring`` track. Returns (logits (B, T, V), the cache with ``len``
    advanced by T; its layers are written in place)."""
    M, k, w = plan.n_stages, plan.k, plan.w
    kM = k * M
    B, T = tokens.shape
    if B % M:
        raise ValueError(f"batch {B} is not a multiple of {M} stages")
    mb = B // M
    ln = cache["len"]
    layers = cache["layers"]
    tracer = resolve_tracer(tracer)

    def phase(label):
        return tracer.phase("compute", cat="ring", track="ring", label=label)

    with phase("embed"):
        emb = _ring_embed(head["embed"], tokens)
    x: List[Optional[torch.Tensor]] = [None] * M     # stage inputs
    hidden: List[Optional[torch.Tensor]] = [None] * M
    for t in range(plan.n_steps):
        with phase(f"microstep[{t}]"):
            nxt: List[Optional[torch.Tensor]] = [None] * M
            for m in range(M):
                e = (t - m) % M                          # microbatch
                j = t - e                                # window index
                if not 0 <= j < kM:
                    continue
                r = j // M
                batch = slice(e * mb, (e + 1) * mb)
                h = emb[batch] if j == 0 else x[m]
                base = m * k * w + r * w
                h = run_ring_window(cfg, window(t, m, r), h, layers,
                                    range(base, base + w), batch, ln[batch])
                if j == kM - 1:
                    hidden[e] = ll.rms_norm(h, head["final_norm"],
                                            cfg.norm_eps)
                nxt[(m + 1) % M] = h                     # the ring hop
            x = nxt
        if on_step is not None:
            on_step(t)
    with phase("head"):
        logits = _ring_unembed(head, torch.cat(hidden, 0))
    return logits, {**cache, "len": ln + T}


def check_ring_cache(cfg: ModelConfig, plan: RingPlan, cache: Dict) -> None:
    rows = {a.shape[0] for a in cache["layers"].values()}
    if rows != {plan.L_pad}:
        raise ValueError(f"cache has {sorted(rows)} layer rows, the ring "
                         f"{plan.L_pad}: put it in ring order with "
                         f"pad_and_permute")


class RingServeStep:
    """The resident ring's serve step: ``step(cache, tokens (B, T)) ->
    (logits (B, T, V), cache)``, T = ``n_tokens`` (1: decode; > 1: the
    speculative verify pass, causal among its tokens; roll rejected
    positions back by resetting ``len``).

    ``params_ring`` is ``ring_params``' output and ``cache`` is
    ``init_cache``'s (or a prefilled one) put in ring order by
    ``pad_and_permute``; its ``len`` is the tokens so far. On the card
    (``graphs``, the default) the step replays from a CUDA graph
    (``engine.GraphedDecode``) and writes the advanced ``len`` into the
    cache's own tensor; ``graphs=False`` runs it eagerly and returns a
    new ``len`` (``ops.use_kernels(False)`` on the card needs it). The
    counterpart of the JAX package's ``build_ring_serve_step``.
    """

    def __init__(self, cfg: ModelConfig, plan: RingPlan, params_ring: Params,
                 *, n_tokens: int = 1, graphs: bool = True, device="cuda"):
        if n_tokens < 1:
            raise ValueError("n_tokens must be >= 1")
        if n_tokens > 1 and cfg.family == "ssm":
            raise ValueError("speculative verify needs a rollbackable KV "
                             "cache; ssm state is irreversible")
        self.cfg, self.plan, self.n_tokens = cfg, plan, n_tokens
        self.params = params_ring
        blocks = params_ring["blocks"]
        if len(blocks) != plan.L_pad:
            raise ValueError(f"{len(blocks)} ring blocks for L_pad "
                             f"{plan.L_pad}")
        head = {k: v for k, v in params_ring.items() if k != "blocks"}
        k, w = plan.k, plan.w

        def window(t, m, r):
            base = m * k * w + r * w
            return blocks[base:base + w]

        def fn(cache, tokens):
            return ring_pass(cfg, plan, head, window, cache, tokens)

        self.graphs = None
        self._step = fn
        if graphs:
            from .engine import GraphedDecode, StepGraphs, dense_scrub
            self.graphs = StepGraphs(device)
            self._step = GraphedDecode(fn, self.graphs, dense_scrub)

    def __call__(self, cache: Dict, tokens: torch.Tensor):
        if tokens.shape[1] != self.n_tokens:
            raise ValueError(f"a {self.n_tokens}-token ring step got "
                             f"{tokens.shape[1]} tokens a sequence")
        check_ring_cache(self.cfg, self.plan, cache)
        return self._step(cache, tokens)


def init_ring_cache(cfg: ModelConfig, plan: RingPlan, batch: int,
                    max_len: int, dtype=torch.float32, device="cuda") -> Dict:
    """``init_cache``'s cache, padded and in ring order."""
    from ..models import init_cache

    cache = init_cache(cfg, batch, max_len, dtype=dtype, device=device)
    cache["layers"] = pad_and_permute(cache["layers"], cfg, plan.n_stages,
                                      plan.k)
    return cache


# --------------------------------------------------------------------------- #
#  the ring across ranks: specs, a rank's part, its pass
# --------------------------------------------------------------------------- #
#
# One rank a (pod, stage, member) of a ("pod", "data", "model") mesh
# (``launch.mesh.RankLayout``): the JAX package's ``build_ring_serve_step``
# with its ``shard_map`` taken apart into processes. A rank holds its
# stage's k*w ring rows, its "model" slice of the FFN and expert weights,
# its vocab shard of the embed and unembed, its Smax/tp lines of every
# cache row and its pod's batch (``ring_param_specs``/``ring_cache_specs``
# cut by ``sharding.local_shard``), and talks to the others only through
# ``runtime.collectives``.

def _stacked_leaf_spec(key: str, nd: int, *, ep: bool = False):
    """Spec of one stacked ring leaf: axis 0 (ring layer order) over
    "data"; the FFN and expert inner dims over "model"; the rest
    replicated."""
    if key in ("w_gate", "w_up") and nd == 4:          # MoE (L, E, d, f)
        return ("data", "model", None, None) if ep \
            else ("data", None, None, "model")
    if key == "w_down" and nd == 4:
        return ("data", "model", None, None) if ep \
            else ("data", None, "model", None)
    if key in ("w_gate", "w_up") and nd == 3:          # GLU (L, d, f)
        return ("data", None, "model")
    if key == "w_down" and nd == 3:
        return ("data", "model", None)
    return ("data",) + (None,) * (nd - 1)


def ring_leaf_spec(path: str, shape, mesh) -> tuple:
    """The sanitized ring spec of the leaf at ``path`` (the stacked shape
    for a block leaf). The ring keeps TP inside each expert (``ep`` off),
    as the JAX ring does."""
    from . import sharding as S

    key = S.leaf_key(path)
    if key == "embed":
        spec = ("model", None)
    elif key == "unembed":
        spec = (None, "model")
    elif key == "final_norm":
        spec = ()
    else:
        spec = _stacked_leaf_spec(key, len(shape))
    return S.sanitize(spec, tuple(shape), mesh)


def ring_param_specs(cfg: ModelConfig, mesh, params: Params) -> Dict:
    """{path: spec} of ring-mode params (``pad_and_permute``d blocks,
    ``pad_vocab``ed head): the layer axis over "data", the FFN and expert
    inner dims over "model", attention and SSM weights replicated over
    "model", the embeddings vocab-sharded."""
    from . import sharding as S

    return {path: ring_leaf_spec(path, tuple(leaf.shape), mesh)
            for path, leaf in S.flatten_with_path(params)}


def ring_cache_spec(path: str, nd: int, mesh) -> tuple:
    """Spec of one ring cache leaf: the layer axis over "data", the KV
    (or latent) sequence over "model", pods over the batch."""
    from . import sharding as S

    pod = ("pod",) if "pod" in mesh else ()
    key = S.leaf_key(path)
    if key == "len":
        return pod
    if key in ("k", "v"):                     # (L, B, S, hk, hd)
        return ("data", pod or None, "model", None, None)
    if key in ("k_scale", "v_scale", "latent"):   # (L, B, S, hk | r)
        return ("data", pod or None, "model", None)
    return ("data",) + ((pod or None),) + (None,) * (nd - 2)


def ring_cache_specs(cfg: ModelConfig, mesh, cache: Dict) -> Dict:
    """{path: spec} of a ring-ordered cache (not sanitized: the sequence
    must split over "model", as ``shard_map`` requires)."""
    from . import sharding as S

    return {path: ring_cache_spec(path, leaf.dim(), mesh)
            for path, leaf in S.flatten_with_path(cache)}


def masked_slot_update(arr: torch.Tensor, new: torch.Tensor,
                       slot: torch.Tensor, s_start: int, s_len: int) -> None:
    """Write ``new`` (B, ...) at absolute line ``slot`` (B,) into the local
    sequence shard ``arr`` (B, s_len, ...) in place, only where the slot
    lands in [s_start, s_start + s_len)."""
    slot = slot.long()
    local = (slot - s_start).clamp(0, s_len - 1)
    ok = (slot >= s_start) & (slot < s_start + s_len)
    bidx = torch.arange(arr.shape[0], device=arr.device)
    cur = arr[bidx, local]
    ok = ok.view((-1,) + (1,) * (cur.dim() - 1))
    arr[bidx, local] = torch.where(ok, new.to(arr.dtype), cur)


def _rank_rows(plan: RingPlan, stage: int) -> np.ndarray:
    """The global layer of each of ``stage``'s k*w ring rows (>= L: a
    zero padding layer)."""
    kw = plan.k * plan.w
    return ring_permutation(plan.L_pad, plan.n_stages, plan.k)[
        stage * kw:(stage + 1) * kw]


def _shard_tree(tree, prefix: str, lead: tuple, mesh, coords, device):
    """Every leaf of a per-layer (``lead`` ()) or head tree cut to the
    rank's part by its ring spec (a block leaf's spec is its stacked
    shape's, axis 0 dropped) and copied to ``device``."""
    from . import sharding as S

    def cut(path, t):
        spec = ring_leaf_spec(path, lead + tuple(t.shape), mesh)[len(lead):]
        return S.local_shard(t, spec, mesh, coords).to(device).contiguous()

    if isinstance(tree, dict):
        return {k: _shard_tree(v, f"{prefix}['{k}']", lead, mesh, coords,
                               device) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        packed = cut(prefix + ".packed", tree.packed)
        scale = cut(prefix + ".scale", tree.scale)
        per = 8 // tree.bits
        if tree.packed.shape[-2] // packed.shape[-2] \
                != tree.scale.shape[-2] // scale.shape[-2]:
            raise ValueError(f"{prefix}: packed rows and scale rows split "
                             f"differently (quantize_ring_params at the "
                             f"real tp keeps them together)")
        shape = tuple(packed.shape[:-2]) + (packed.shape[-2] * per,
                                            packed.shape[-1])
        return QuantizedTensor(packed, scale, tree.bits, tree.group, shape)
    return cut(prefix, tree)


def _tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


def rank_head(source, cfg: ModelConfig, layout, *, device=None) -> Params:
    """Rank ``layout``'s part of the head, read once from ``source`` (a
    ``ParamStore``'s mapped head file, or a ``ResidentSource``): the vocab
    shard of ``embed`` (and ``unembed``) padded to a multiple of tp, and
    ``final_norm``."""
    device = torch.device(device or layout.device)
    head = getattr(source, "head_view", source.head)()
    head = pad_vocab(head, cfg, layout.tp)
    return _shard_tree(head, "", (), layout.mesh, layout.coords, device)


def rank_params(source, cfg: ModelConfig, plan: RingPlan, layout, *,
                device=None) -> Params:
    """Rank ``layout``'s part of the ring's parameters, read from
    ``source`` (a ``runtime.paramstore.ParamSource``: a ``ParamStore``, of
    which the rank maps only its stage's layer files and the head, or a
    ``ResidentSource``): ``blocks``, the stage's k*w ring rows in order
    (zero layers past L) with this member's slice of every FFN and expert
    stack (q4 leaves cut as packed bytes and scale rows,
    ``quantize_ring_params`` at the real tp keeping them together), each
    prepared as ``ring_params`` prepares a row; the head (``rank_head``);
    and ``nbytes``, the bytes cut out before any q4 leaf was dequantized
    (the rank's share of the model)."""
    from ..bridge import block_from_tree

    device = torch.device(device or layout.device)
    mesh, coords = layout.mesh, layout.coords
    blocks, nbytes, zero = [], 0, None
    for gid in _rank_rows(plan, layout.stage):
        if gid < cfg.n_layers:
            tree = _shard_tree(source.layer(int(gid)), "['blocks']",
                               (plan.L_pad,), mesh, coords, device)
        else:
            if zero is None:
                zero = _shard_tree(source.layer(0), "['blocks']",
                                   (plan.L_pad,), mesh, coords, "meta")
            tree = map_tree(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                                  device=device), zero)
        nbytes += _tree_nbytes(tree)
        blocks.append(block_from_tree(_prep_ring_layer(tree)))
    head = rank_head(source, cfg, layout, device=device)
    nbytes += _tree_nbytes(head)
    return dict(head, blocks=blocks, nbytes=nbytes)


@dataclasses.dataclass(frozen=True)
class LeafCut:
    """One leaf of a store's layer file and a rank's part of it: ``spec``
    (the store's ``paramstore.LeafSpec``), ``split`` (its ring spec, the
    layer axis dropped) and ``local`` (a ``LeafSpec`` of the part at its
    offset in the rank's flat layer: a q4 part's quant record carries the
    part's unpacked shape)."""
    spec: Any
    split: tuple
    local: Any

    def copy(self, src: torch.Tensor, dst: torch.Tensor, mesh,
             coords) -> None:
        """Copy the rank's part of the leaf out of ``src`` (a layer file's
        bytes, e.g. its mapping) into ``dst`` (the rank's flat layer):
        bytes the rank does not own are never copied. The leaf is cut as
        bytes (its elements' bytes a trailing axis), so no offset needs
        to be aligned to its element size."""
        from . import sharding as S

        isz = self.spec.nbytes // math.prod(self.spec.shape)
        raw = src[self.spec.offset:self.spec.offset + self.spec.nbytes]
        part = S.local_shard(raw.view(tuple(self.spec.shape) + (isz,)),
                             self.split, mesh, coords)
        out = dst[self.local.offset:self.local.offset + self.local.nbytes]
        out.view(tuple(self.local.shape) + (isz,)).copy_(part)


def rank_layer_cuts(leaves: Sequence, plan: RingPlan, layout
                    ) -> List[LeafCut]:
    """The rank's part of every leaf of a store's layer (``leaves``: the
    manifest's ``LeafSpec``s, ``ParamStore.layer_leaves``) by the ring's
    specs, as ``rank_params`` cuts a layer, laid out leaf after leaf in a
    flat layer of their own. q4 leaves are cut as packed rows and scale
    rows together; rows that do not split together raise, as
    ``_shard_tree`` raises."""
    from .paramstore import LeafSpec
    from . import sharding as S

    mesh = layout.mesh
    cuts, offset, parts = [], 0, {}
    for spec in leaves:
        path = "['blocks']" + "".join(f"['{k}']"
                                      for k in spec.key.split("/"))
        if spec.part is not None:
            path += "." + spec.part
        # the sanitized spec of the stacked leaf: an entry a dimension
        split = tuple(ring_leaf_spec(path, (plan.L_pad,) + tuple(spec.shape),
                                     mesh)[1:])
        shape = tuple(d // S.axis_size(mesh, e)
                      for d, e in zip(spec.shape, split))
        nbytes = spec.nbytes // math.prod(spec.shape) * math.prod(shape)
        if spec.part is not None:
            parts.setdefault(spec.key, {})[spec.part] = (spec.shape, shape)
        cuts.append(LeafCut(spec, split, LeafSpec(
            key=spec.key, shape=shape, dtype=spec.dtype, offset=offset,
            nbytes=nbytes, part=spec.part, quant=spec.quant)))
        offset += nbytes
    for i, c in enumerate(cuts):
        if c.spec.part is None:
            continue
        (pf, pl), (sf, sl) = parts[c.spec.key]["packed"], \
            parts[c.spec.key]["scale"]
        if pf[-2] // pl[-2] != sf[-2] // sl[-2]:
            raise ValueError(f"{c.spec.key}: packed rows and scale rows "
                             f"split differently (quantize_ring_params at "
                             f"the real tp keeps them together)")
        per = 8 // int(c.spec.quant["bits"])
        quant = dict(c.spec.quant, shape=list(pl[:-2]) + [pl[-2] * per,
                                                           pl[-1]])
        cuts[i] = dataclasses.replace(
            c, local=dataclasses.replace(c.local, quant=quant))
    return cuts


def rank_cache(cache: Dict, cfg: ModelConfig, plan: RingPlan, layout, *,
               device=None) -> Dict:
    """Rank ``layout``'s part of a one-device cache (``init_cache``'s
    layout, layers in model order, e.g. a prefill's): its stage's k*w ring
    rows (zero rows past L), its pod's batch, its Smax/tp lines of every
    k/v/scale/latent row (an ssm state whole), copied to ``device``."""
    from . import sharding as S

    device = torch.device(device or layout.device)
    mesh, coords = layout.mesh, layout.coords
    rows = _rank_rows(plan, layout.stage)
    layers = {}
    for name, a in cache["layers"].items():
        spec = ring_cache_spec(f"['layers']['{name}']", a.dim(), mesh)[1:]
        parts = []
        for gid in rows:
            row = a[int(gid)] if gid < cfg.n_layers else \
                torch.zeros_like(a[0])
            parts.append(S.local_shard(row, spec, mesh, coords))
        layers[name] = torch.stack(parts).to(device)
    ln = S.local_shard(cache["len"], ring_cache_spec("['len']", 1, mesh),
                       mesh, coords)
    return {"len": ln.to(device).contiguous(), "layers": layers}


def rank_init_cache(cfg: ModelConfig, plan: RingPlan, layout, batch: int,
                    max_len: int, *, dtype=torch.float32, device=None
                    ) -> Dict:
    """Rank ``layout``'s part of an empty ring cache (``init_cache``'s
    zeros, as ``rank_cache`` would cut them), made at the part's shapes
    without the whole cache."""
    from ..models import init_cache
    from . import sharding as S

    device = torch.device(device or layout.device)
    mesh = layout.mesh
    like = init_cache(cfg, batch, max_len, dtype=dtype, device="meta")
    layers = {}
    for name, a in like["layers"].items():
        spec = ring_cache_spec(f"['layers']['{name}']", a.dim(), mesh)[1:]
        row = S.local_shard(a[0], spec, mesh, layout.coords)
        layers[name] = torch.zeros((plan.k * plan.w,) + tuple(row.shape),
                                   dtype=a.dtype, device=device)
    ln = S.local_shard(like["len"], ring_cache_spec("['len']", 1, mesh),
                       mesh, layout.coords)
    return {"len": torch.zeros(ln.shape, dtype=ln.dtype, device=device),
            "layers": layers}


class ResidentWindows:
    """A rank's windows from its resident rows (``rank_params``'
    ``blocks``): ``get(r)`` is window r's w blocks; the streamed
    counterpart is ``streaming.RankWindowPrefetcher``."""

    def __init__(self, blocks: Sequence, w: int):
        self.blocks, self.w = blocks, w

    def begin_pass(self) -> None:
        pass

    def get(self, r: int) -> Sequence:
        return self.blocks[r * self.w:(r + 1) * self.w]

    def done(self, r: int) -> None:
        pass


@dataclasses.dataclass
class _Shard:
    """A rank's place in its stage's tensor-parallel group, for the ring
    layers: the "model" axis, the first global line of its cache shard
    and the shard's lines (0 for an ssm state); ``offsets`` False is the
    negative control that masks every shard as if it began at line 0;
    ``probe(name, tensor)`` sees the replicated activations."""
    model: Any
    s_start: int
    s_len: int
    offsets: bool = True
    probe: Optional[Callable] = None

    def seen(self, name: str, t: torch.Tensor) -> None:
        if self.probe is not None:
            self.probe(name, t)


def _rank_gqa(cfg: ModelConfig, p, h, c, ln, pos, sh: _Shard):
    """A GQA layer's attention on one rank: ``seq_attention`` of its q, k
    and v, then the output projection."""
    mb, T = h.shape[0], h.shape[1]
    q, k, v = ll.attn_qkv(p, cfg, h, pos)
    out = seq_attention(cfg, q, k, v, c, ln, sh)
    return ll.qmm(out.reshape(mb, T, -1).to(h.dtype), p.wo)


def seq_attention(cfg: ModelConfig, q, k, v, c, ln, sh: _Shard
                  ) -> torch.Tensor:
    """GQA attention over a cache split by sequence over ``sh.model``:
    the new lines (k, v (mb, T, hk, hd)) written where they fall in this
    member's shard ``c``, B5 with its stats over the shard
    (``layers.shard_attention_stats``; the plain stats on the CPU), the
    shards merged over the group. -> (mb, T, H, hd) f32, equal on every
    member."""
    T = q.shape[1]
    window = cfg.attn_window
    Smax = sh.s_len * sh.model.size
    rolling = window is not None and Smax == window
    if T > 1 and rolling:
        raise ValueError("multi-token ring needs Smax > window")
    quantized = "k_scale" in c
    if quantized:
        k_wr, ksc = ll.quantize_kv(k)
        v_wr, vsc = ll.quantize_kv(v)
    else:
        k_wr, v_wr = k, v
    for t in range(T):                       # small (draft block)
        slot = (ln + t) % window if rolling \
            else torch.clamp(ln + t, max=Smax - 1)
        masked_slot_update(c["k"], k_wr[:, t], slot, sh.s_start, sh.s_len)
        masked_slot_update(c["v"], v_wr[:, t], slot, sh.s_start, sh.s_len)
        if quantized:
            masked_slot_update(c["k_scale"], ksc[:, t], slot, sh.s_start,
                               sh.s_len)
            masked_slot_update(c["v_scale"], vsc[:, t], slot, sh.s_start,
                               sh.s_len)
    kv_len = torch.clamp(ln + T, max=Smax) if window is not None else ln + T
    # a rolling buffer holds only in-window lines, at permuted slots
    eff_window = None if rolling else window
    local = kv_len - sh.s_start if sh.offsets else kv_len
    if quantized:
        o, lse = ll.shard_attention_stats(q, c["k"], c["v"], local,
                                          window=eff_window,
                                          k_scale=c["k_scale"],
                                          v_scale=c["v_scale"])
    else:
        o, lse = ll.shard_attention_stats(q, c["k"].to(q.dtype),
                                          c["v"].to(q.dtype), local,
                                          window=eff_window)
    out = ll.merge_attention_lse(o, lse, sh.model)      # (mb, T, H, hd)
    sh.seen("attention", out)
    return out


def _rank_mla(cfg: ModelConfig, p, h, c, ln, pos, sh: _Shard):
    """MLA's absorbed attention on one rank (the JAX ring's
    ``_ring_mla_layer``, plain torch): ``mla_seq_attention``, then W_UV
    and the output projection."""
    mb, T = h.shape[0], h.shape[1]
    H, r_kv = cfg.n_heads, cfg.kv_lora_rank
    q_nope, q_rope, _, lat_cat = ll.mla_project(p, cfg, h, pos)
    o_lat = mla_seq_attention(cfg, p, q_nope, q_rope, lat_cat, c, ln, sh,
                              h.dtype)
    wv = p.wv_b.reshape(r_kv, H, cfg.v_head_dim)
    out = ll._einsum("bthr,rhv->bthv", o_lat.to(h.dtype), wv)
    return ll.qmm(out.reshape(mb, T, -1), p.wo)


def mla_seq_attention(cfg: ModelConfig, p, q_nope, q_rope, lat_cat, c, ln,
                      sh: _Shard, dtype) -> torch.Tensor:
    """MLA's absorbed attention over a latent cache split by sequence
    over ``sh.model``: the new latent lines written where they fall in
    this member's shard ``c``, the scores over its lines, the latent stats
    merged over the group. -> (mb, T, H, r_kv) f32."""
    T = q_nope.shape[1]
    lc = c["latent"]
    for t in range(T):
        masked_slot_update(lc, lat_cat[:, t], ln + t, sh.s_start, sh.s_len)
    s_all, lat_all = ll._mla_scores(p, cfg, q_nope, q_rope, lc, dtype)
    dev = lc.device
    spos = torch.arange(sh.s_len, device=dev) + (
        sh.s_start if sh.offsets else 0)
    qpos = ln.long()[:, None] + torch.arange(T, device=dev)[None]
    mask = (spos[None, None] <= qpos[..., None])[:, None]   # (mb,1,T,sl)
    s_all = torch.where(mask, s_all, -math.inf)
    m = s_all.amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    pr = torch.where(mask, torch.exp(s_all - m_safe[..., None]), 0.0)
    acc = torch.einsum("bhts,bsr->bhtr", pr, lat_all.float())
    o, lse = ll.stats_to_lse(acc, m, pr.sum(-1), torch.float32)
    o_lat = ll.merge_attention_lse(o, lse, sh.model)     # (mb, T, H, r)
    sh.seen("attention", o_lat)
    return o_lat


def _rank_attn_layer(cfg: ModelConfig, blk, x, c, ln, sh: _Shard):
    """One dense, moe or vlm layer (GQA or MLA) on one rank: the
    sequence-split attention, then the FFN split over the "model" group
    and summed."""
    from ..models.model import default_positions

    pos = default_positions(cfg, x.shape[0], x.shape[1], ln)
    h = ll.rms_norm(x, blk.attn_norm, cfg.norm_eps)
    attn = _rank_mla if cfg.mla else _rank_gqa
    x = x + attn(cfg, blk.attn, h, c, ln, pos, sh)
    g = ll.rms_norm(x, blk.ffn_norm, cfg.norm_eps)
    return x + ll.block_ffn(blk, cfg, g, lossless=True, tp=sh.model)


def _rank_embed(embed: torch.Tensor, tokens: torch.Tensor, ax
                ) -> torch.Tensor:
    """The vocab-sharded embed: this member's rows for the tokens in its
    shard, zeros elsewhere, summed over the "model" group."""
    from .collectives import psum

    v_loc = embed.shape[0]
    off = ax.index * v_loc
    tok = tokens.long()
    ok = (tok >= off) & (tok < off + v_loc)
    emb = embed[(tok - off).clamp(0, v_loc - 1)]
    return psum(torch.where(ok[..., None], emb, torch.zeros_like(emb)), ax)


def rank_greedy(logits: torch.Tensor, ax, vocab: int) -> torch.Tensor:
    """Greedy tokens from vocab-sharded logits (B, T, V_pad/tp): the
    argmax of the whole vocabulary (padded columns excluded), equal on
    every member; ties go to the lowest index, as ``torch.argmax`` of
    the full row gives them. (B, T) int32."""
    from .collectives import all_gather

    v_loc = logits.shape[-1]
    off = ax.index * v_loc
    cols = torch.arange(off, off + v_loc, device=logits.device)
    lg = torch.where(cols < vocab, logits.float(), -math.inf)
    idx = lg.argmax(-1)
    best = torch.stack([lg.gather(-1, idx[..., None])[..., 0].double(),
                        (idx + off).double()])
    parts = all_gather(best, ax)                    # (tp, 2, B, T)
    val, pick = parts[0, 0], parts[0, 1]
    for i in range(1, parts.shape[0]):           # a later shard: only if >
        more = parts[i, 0] > val
        val = torch.where(more, parts[i, 0], val)
        pick = torch.where(more, parts[i, 1], pick)
    return pick.to(torch.int32)


def gather_logits(logits: torch.Tensor, ax, vocab: int) -> torch.Tensor:
    """The full vocabulary's logits (B, T, vocab) from every member's
    shard."""
    from .collectives import all_gather

    parts = all_gather(logits, ax)
    return torch.cat(list(parts), -1)[..., :vocab]


class RankRingStep:
    """The ring across ranks' serve step on one rank: ``step(cache, tokens
    (B, T)) -> (logits (B, T, V_pad/tp), cache)`` over the rank's pod
    batch, T = ``n_tokens`` (> 1: the verify pass, causal among its
    tokens). Every rank of the world calls it together: the counterpart of
    the JAX package's ``build_ring_serve_step`` ``local_fn`` over a
    ``("pod", "data", "model")`` mesh.

    ``params`` is ``rank_params``' and ``cache`` ``rank_cache``'s (its
    ``len``: the tokens so far). ``windows``: where the stage's rows come
    from, a window (w rows) at a time: ``ResidentWindows`` over
    ``params["blocks"]`` (the default), or the rank's
    ``streaming.RankWindowPrefetcher`` (then ``params`` needs only the
    head, ``rank_head``'s), which the step tells when a pass begins and
    when a window's last microbatch is done. A pass: the vocab-sharded
    embed summed
    over "model"; at microstep t, stage m takes microbatch e = (t - m) mod
    M through window r = (t - e) // M of its rows where it is in the
    schedule (the JAX step computes and masks the others; here they are
    skipped and send nothing), then hands its output to stage m + 1 (only
    where that stage will read it); every layer's attention runs B5 with
    its stats over the rank's sequence shard and merges the shards over
    "model", its FFN is split over "model" and summed; the final hiddens,
    normed on the stage of the last window, summed over the ring; the
    local logits from this member's vocab shard. Cache lines and ``len``
    are written in place. The step runs eagerly: gloo ops cannot sit in a
    CUDA graph.

    ``tracer``: each microstep, the embed and the head are ``compute``
    phases on the ``ring`` track and each collective a ``comms`` phase on
    the ``comm`` track (``RankLayout.set_tracer``). ``probe(name, t)``
    sees x after every layer, every merged attention output and the final
    hiddens (the tests gather them to hold the members equal). ``offsets``
    False is the negative control: members merge without their shard's
    offset.
    """

    def __init__(self, cfg: ModelConfig, plan: RingPlan, layout,
                 params: Params, *, n_tokens: int = 1, tracer=None,
                 probe: Optional[Callable] = None, offsets: bool = True,
                 windows=None):
        if n_tokens < 1:
            raise ValueError("n_tokens must be >= 1")
        if n_tokens > 1 and cfg.family == "ssm":
            raise ValueError("speculative verify needs a rollbackable KV "
                             "cache; ssm state is irreversible")
        if layout.n_stages != plan.n_stages:
            raise ValueError(f"a {plan.n_stages}-stage plan on a "
                             f"{layout.n_stages}-stage layout")
        if windows is None:
            if len(params["blocks"]) != plan.k * plan.w:
                raise ValueError(f"{len(params['blocks'])} blocks on a "
                                 f"rank, the plan's stage holds "
                                 f"{plan.k * plan.w}")
            windows = ResidentWindows(params["blocks"], plan.w)
        self.windows = windows
        self.cfg, self.plan, self.layout = cfg, plan, layout
        self.n_tokens, self.params = n_tokens, params
        self.tracer = resolve_tracer(tracer)
        self.probe, self.offsets = probe, offsets
        layout.set_tracer(tracer)

    def _shard(self, layers: Dict) -> _Shard:
        name = "latent" if self.cfg.mla else "k"
        s_len = layers[name].shape[2] if name in layers else 0
        return _Shard(self.layout.model, self.layout.member * s_len, s_len,
                      self.offsets, self.probe)

    def __call__(self, cache: Dict, tokens: torch.Tensor):
        from .collectives import ppermute, psum

        cfg, plan, lay = self.cfg, self.plan, self.layout
        T = self.n_tokens
        if tokens.shape[1] != T:
            raise ValueError(f"a {T}-token ring step got {tokens.shape[1]} "
                             f"tokens a sequence")
        M, k, w = plan.n_stages, plan.k, plan.w
        kM, m = k * M, lay.stage
        B = tokens.shape[0]
        if B % M:
            raise ValueError(f"batch {B} is not a multiple of {M} stages")
        mb = B // M
        ln, layers = cache["len"], cache["layers"]
        p = self.params
        sh = self._shard(layers)
        layer = _ring_ssd_layer if cfg.family == "ssm" else _rank_attn_layer
        tr = self.tracer

        def phase(label):
            return tr.phase("compute", cat="ring", track="ring", label=label)

        with phase("embed"):
            emb = _rank_embed(p["embed"], tokens, lay.model)
        like = emb[:mb]
        hidden = torch.zeros_like(emb)
        x = None

        def in_schedule(stage, t):
            j = t - (t - stage) % M
            return j, 0 <= j < kM

        # stage m runs window r over microbatches 0..M-1 at microsteps
        # m + rM .. m + rM + M - 1: fetched at the first, done after the
        # last
        self.windows.begin_pass()
        blocks: Sequence = ()
        for t in range(plan.n_steps):
            j, valid = in_schedule(m, t)
            out = None
            if valid:
                with phase(f"microstep[{t}]"):
                    e = (t - m) % M
                    r = j // M
                    if e == 0:
                        blocks = self.windows.get(r)
                    batch = slice(e * mb, (e + 1) * mb)
                    h = emb[batch] if j == 0 else x
                    for i, blk in enumerate(blocks):
                        c = {n: a[r * w + i, batch]
                             for n, a in layers.items()}
                        if layer is _ring_ssd_layer:
                            h = layer(cfg, blk, h, c, ln[batch])
                        else:
                            h = layer(cfg, blk, h, c, ln[batch], sh)
                        sh.seen("x", h)
                    if e == M - 1:
                        self.windows.done(r)
                    if j == kM - 1:
                        hidden[batch] = ll.rms_norm(h, p["final_norm"],
                                                    cfg.norm_eps)
                    out = h.to(like.dtype)      # the carry's dtype, as JAX's
            # the hop: stage m + 1 reads at t + 1 what stage m made at t
            # unless it is the last window's or stage m + 1 starts there
            j_next, _ = in_schedule(m, t + 1)
            x = ppermute(out, lay.ring, like=like,
                         send=valid and j < kM - 1,
                         recv=1 <= j_next < kM)
        with phase("head"):
            hidden = psum(hidden, lay.ring)
            sh.seen("hidden", hidden)
            logits = _ring_unembed(p, hidden)
        if isinstance(ln, torch.Tensor):
            ln.add_(T)
        return logits, cache


def _replicated_probe(ax, seen: Dict[str, int], unequal: List[str]):
    """A ``RankRingStep`` probe that gathers each replicated activation
    over ``ax`` and records any member whose bytes differ."""
    from .collectives import all_gather

    def probe(name: str, t: torch.Tensor) -> None:
        parts = all_gather(t.contiguous(), ax)
        seen[name] = seen.get(name, 0) + 1
        if any(not torch.equal(parts[0], parts[i])
               for i in range(1, parts.shape[0])):
            unequal.append(name)
    return probe


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_ring_job(ctx, *, cfg: ModelConfig, n_stages: int, tp: int,
                  pods: int = 1, k: int = 1, store: str, cache,
                  first: np.ndarray, steps: int,
                  verify_tokens: int = 1, verify_reps: int = 1,
                  keep_logits: bool = False, check_replicated: bool = False,
                  offsets: bool = True, return_cache: bool = False,
                  trace: bool = False, fail_rank: Optional[int] = None,
                  stream: Optional[Dict[str, Any]] = None) -> Dict:
    """One rank's run of the ring across ranks (a ``launch.mesh.RankWorld``
    job; every rank of a ``pods x n_stages x tp`` world runs it): its part
    of the layer store at ``store`` (``rank_params``) and of the
    one-device cache ``cache`` (a dict, or a ``torch.save`` file, read
    mapped; ``rank_cache``), then ``steps`` greedy steps from ``first``
    (B, 1), then, with ``verify_tokens`` T > 1, ``verify_reps`` T-token
    verify passes over the last token repeated, each from the same
    length. Returns this rank's coordinates, the clock at the job's start
    (``telemetry.clock``, one monotonic clock for every process), the
    seconds its groups and its part of the weights and cache took to
    set up (``load_s``), its pod's greedy tokens
    (steps, B/pods), each step's seconds between syncs, the full
    vocabulary's logits of every step (``keep_logits``: on each pod's
    member 0 of stage 0 only) and of the first verify pass, the verify
    passes' seconds, its kernel launches (``ops.launch_counts()`` over
    the greedy steps), the bytes of its part of the model, the replicated
    activations it held equal to the bit across its stage's members
    (``check_replicated``), its cache part after each step
    (``return_cache``) and, with ``trace``, the steps' share spent in
    collectives and their staging. ``fail_rank``: that rank raises at its
    second step (the driver's failure path). ``stream``: the rows stream
    from the store instead (``rank_stream_job``)."""
    from ..kernels import ops
    from .paramstore import ParamStore
    from .telemetry import Tracer

    t0 = clock()
    lay = ctx.layout(n_stages, tp, pods)
    dev = lay.device
    plan = RingPlan.make(cfg, n_stages, k)
    tracer = Tracer() if trace else None
    src = ParamStore(store)
    windows = None
    if stream is None:
        try:
            params = rank_params(src, cfg, plan, lay)
        finally:
            src.close()
    else:
        windows, params = _rank_windows(src, cfg, plan, lay, tracer=tracer,
                                        **stream)
    if isinstance(cache, str):
        cache = torch.load(cache, map_location="cpu", mmap=True)
    c = rank_cache(cache, cfg, plan, lay)
    del cache
    _sync(dev)
    load_s = clock() - t0
    B = first.shape[0]
    rows = slice(lay.pod * (B // pods), (lay.pod + 1) * (B // pods))
    seen: Dict[str, int] = {}
    unequal: List[str] = []
    probe = _replicated_probe(lay.model, seen, unequal) \
        if check_replicated else None
    step = RankRingStep(cfg, plan, lay, params, tracer=tracer, probe=probe,
                        offsets=offsets, windows=windows)
    tok = torch.as_tensor(np.asarray(first)[rows], device=dev).int()
    toks, secs, kept, caches = [], [], [], []
    ops.reset_launch_counts()
    tr = resolve_tracer(tracer)
    for t in range(steps):
        if fail_rank == ctx.rank and t == 1:
            raise RuntimeError(f"rank {ctx.rank}: injected failure at step "
                               f"{t}")
        _sync(dev)
        ts = clock()
        with tr.token_step(t, track="decode"):
            logits, c = step(c, tok)
            nxt = rank_greedy(logits, lay.model, cfg.vocab)
            _sync(dev)
        secs.append(clock() - ts)
        toks.append(nxt.cpu().numpy())
        if return_cache:
            caches.append({n: (a.float() if a.dtype == torch.bfloat16
                               else a).cpu().numpy().copy()
                           for n, a in c["layers"].items()})
        if keep_logits and lay.stage == 0:
            full = gather_logits(logits, lay.model, cfg.vocab)
            if lay.member == 0:
                kept.append(full.float().cpu().numpy())
        tok = nxt
    counts = ops.launch_counts()
    out = {"rank": ctx.rank, "pod": lay.pod, "stage": lay.stage,
           "member": lay.member, "t_start": t0, "load_s": load_s,
           "tokens": np.stack(toks) if toks else np.zeros((0, 0)),
           "step_s": secs, "logits": kept, "launches": counts,
           "nbytes": params["nbytes"], "replicated": seen,
           "unequal": unequal, "verify_s": [], "verify_logits": None,
           "comm_share": None}
    if trace:
        stalls = tracer.stalls()
        wall = sum(s.wall_s for s in stalls)
        out["comm_share"] = sum(s.comms_s for s in stalls) / max(wall, 1e-12)
        out["comm_s"] = [s.comms_s for s in stalls]
    T = verify_tokens
    if T > 1:
        vstep = RankRingStep(cfg, plan, lay, params, n_tokens=T,
                             probe=probe, offsets=offsets, windows=windows)
        ln0 = c["len"].clone()
        vt = tok[:, -1:].expand(-1, T).contiguous()
        for i in range(verify_reps):
            c["len"].copy_(ln0)
            _sync(dev)
            ts = clock()
            vl, c = vstep(c, vt)
            _sync(dev)
            out["verify_s"].append(clock() - ts)
            if i == 0:
                out["verify_logits"] = gather_logits(
                    vl, lay.model, cfg.vocab).float().cpu().numpy()
        c["len"].copy_(ln0)
    out["caches"] = caches
    if windows is not None:
        # a failed job ends the whole world, so only a finished one has a
        # prefetcher to stop
        out["prefetch"] = windows.report()
        windows.close()
        src.close()
    return out


def _rank_windows(store, cfg: ModelConfig, plan: RingPlan, layout, *,
                  depth: int = 2, policy=None, fault=None, tracer=None):
    """A rank's streamed windows over ``store`` (an open ``ParamStore``)
    and its head: (``streaming.RankWindowPrefetcher``, the head with
    ``nbytes``, the rank's share of the model as ``rank_params`` counts
    it). ``fault``: ``(rank, faults.FaultSpec)``, that rank's layer reads
    go through a ``faults.FaultyStore`` firing the spec; ``tracer``: the
    prefetcher's spans."""
    from .faults import FaultInjector, FaultyStore
    from .streaming import RankWindowPrefetcher

    if fault is not None and fault[0] == layout.rank:
        store = FaultyStore(store, FaultInjector([fault[1]]))
    head = rank_head(store, cfg, layout)
    pf = RankWindowPrefetcher(store, cfg, plan, layout, depth=depth,
                              policy=policy, tracer=tracer)
    nbytes = _tree_nbytes(head) + plan.k * plan.w * pf.local_nbytes
    return pf, dict(head, nbytes=nbytes)


def rank_stream_job(ctx, *, depth: int = 2, policy=None, fault=None,
                    **kwargs) -> Dict:
    """``rank_ring_job`` with the rank's rows streamed from the store
    (``streaming.RankWindowPrefetcher``: only its stage's windows and
    only its part of each leaf, ``depth`` windows staged ahead of the
    compute front, each released after its last microbatch of a pass)
    instead of held resident: the same result plus ``prefetch``, the
    rank's ``RankWindowPrefetcher.report`` (bytes read a pass, peak
    staged bytes, stall, retries). ``policy``: the reads' ``IOPolicy``;
    ``fault``: ``(rank, faults.FaultSpec)`` fired on that rank's reads.
    A read that fails past its retries raises on its rank, so the job
    fails with a ``launch.mesh.RankFailure`` naming it."""
    return rank_ring_job(ctx, stream=dict(depth=depth, policy=policy,
                                          fault=fault), **kwargs)
