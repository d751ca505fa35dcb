"""The piped ring (PRP) of the port: its layout, its serve step, and the
packed-int4 layer bank (``repro.runtime.serve``'s ring, in PyTorch).

Mapping: the model's (padded) L layers split into k*M windows of w
layers; stage m owns windows {r*M + m : r < k}, stored stage-major as one
block of k*w ring rows (``ring_permutation``). All M stages run in one
process on one device (``launch.mesh.RingLayout``): each stage has its
own k*w rows of the layer bank and of the cache, and the ring hop is a
hand-off of a stage's output to the next stage. Tensor parallelism inside
a stage (the JAX package's "model" axis) is ROADMAP Queue A item 6, so
the sequence-split attention merge, the vocab-sharded embed and unembed
and the split FFN are their tp = 1 identities here.

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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import layers as ll
from ..quant.grouped import (QuantizedTensor, dequantize_leaf, map_tree,
                             quantize_q4, tree_tensors)
from .telemetry import resolve_tracer

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
