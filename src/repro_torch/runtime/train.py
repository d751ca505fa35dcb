"""Training of the port: ``repro.runtime.train``'s loss and train step on
one device.

  * ``lm_loss``: mean next-token cross entropy over f32 logits (logsumexp
    less the gold logit) plus the z-loss, through
    ``models.model.train_forward`` (the body ``forward`` wraps in
    ``no_grad``); a vlm drops its prepended patch rows, whisper takes
    its frames as ``embeds``;
  * ``make_train_step``: gradients by autograd, cast to ``grad_dtype``
    before accumulation, microbatches accumulated in f32 seeded with the
    first microbatch's gradients over ``n_micro`` (the JAX step's order),
    then ``AdamW.update`` in place.

The trainer makes a model's float leaves trainable (``make_trainable``);
serving stays under ``no_grad``. A packed ``QuantizedTensor`` leaf is
refused: nothing in the JAX package trains a q4 store. On the card the
no-cache forward of the ssm family runs kernel B6 under autograd
(``kernels.ssd_scan.SSDScan``: its backward differentiates the plain
scan); no other kernel is on this path (the no-cache attention is the
plain chunked attention, as in the reference).

``RankTrainStep`` is the JAX package's ``jitted_train_step`` across the
ranks of a ``launch.mesh.RankWorld``: the same step, each rank holding
its part of the parameters and moments leaf by leaf as that function's
shardings place them, the forward ``runtime.gspmd.GspmdModel``'s:

  * ``fsdp``: parameters and both moments under ``param_shardings``
    ("data" and "model"); each layer's leaves are gathered over "data" in
    the forward and their gradients reduce-scattered back in the backward
    (``collectives.fsdp_gather``);
  * ``zero1``: parameters under ``param_shardings(style="zero1")``
    (tensor-parallel only), moments under ``zero1_moment_shardings`` (the
    first free dimension "data" divides split over it); each step packs
    every gradient into one reduce-scatter over "data" to the moments'
    layout, updates the rank's part and packs the updated parts into one
    all-gather over "data".

Tokens and labels follow ``data_sharding`` (the rank cuts its rows of
each microbatch); the loss is the global mean (each batch-axis rank's
mean over its rows, weighted by one over the pods x stages that share
the batch), taken over the vocab shards; gradients also sum over the
pods. The clipping norm sums every rank's squares with each leaf counted
once (a replicated leaf's squares divided by its replicas), and goes to
``AdamW.update`` as ``gnorm``. ``rank_train_job`` runs it on a world.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..models import model as M
from ..quant.grouped import QuantizedTensor
from . import sharding as S
from .collectives import (all_gather, op_counts, pmax, psum, reduce_scatter,
                          reset_op_counts, tp_sum)
from .optim import AdamState, AdamW, global_norm


def trainable(params: nn.Module) -> List[torch.Tensor]:
    """The leaves a step updates, in the order of gradients and moments:
    ``params.parameters()``."""
    return list(params.parameters())


def make_trainable(params: nn.Module) -> List[torch.Tensor]:
    """Set ``requires_grad`` on every float leaf of the model and return
    them (``trainable``); a ``QuantizedTensor`` leaf raises
    ``ValueError``."""
    for name, mod in params.named_modules():
        for key, val in vars(mod).items():
            if isinstance(val, QuantizedTensor):
                raise ValueError(
                    f"{name or 'model'}.{key} is a packed QuantizedTensor: "
                    f"a q4 store is not trainable (nothing in the JAX "
                    f"package trains one); dequantize it first")
    leaves = trainable(params)
    for p in leaves:
        if not p.is_floating_point():
            raise ValueError(f"a {p.dtype} leaf is not trainable")
        p.requires_grad_(True)
    return leaves


def lm_loss(params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, *, embeds: Optional[torch.Tensor] = None,
            z_loss: float = 1e-4, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy. labels = tokens shifted outside.
    The gold logit is gathered (the reference's one-hot reduction sums
    the same value with zeros: equal)."""
    logits = M.train_forward(params, cfg, tokens, embeds=embeds,
                             remat=remat)
    if embeds is not None and cfg.family != "audio":
        logits = logits[:, embeds.shape[1]:]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = (logz - gold).mean()
    if z_loss:
        loss = loss + z_loss * logz.square().mean()
    return loss


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *,
                    microbatch: Optional[int] = None,
                    grad_dtype: Optional[str] = "bfloat16",
                    remat: bool = True,
                    has_embeds: bool = False) -> Callable:
    """Build ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``params`` a model (updated in place and returned),
    ``opt_state`` an ``AdamState`` over its ``trainable`` leaves, batch
    {"tokens", "labels"[, "embeds"]} tensors on the model's device;
    metrics {"loss", "grad_norm", "step"} stay tensors on the device.

    ``microbatch``: if set, the batch is split into microbatches run one
    after another with f32 gradient accumulation."""
    gdt = getattr(torch, grad_dtype) if grad_dtype is not None else None

    def grads_of(params, leaves, tokens, labels, embeds):
        loss = lm_loss(params, cfg, tokens, labels, embeds=embeds,
                       remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if gdt is not None:
            grads = [g.to(gdt) for g in grads]
        return loss.detach(), grads

    def train_step(params, opt_state: AdamState, batch: Dict):
        leaves = make_trainable(params)
        tokens, labels = batch["tokens"], batch["labels"]
        embeds = batch.get("embeds") if has_embeds else None
        if microbatch is None or tokens.shape[0] <= microbatch:
            loss, grads = grads_of(params, leaves, tokens, labels, embeds)
        else:
            n_micro = tokens.shape[0] // microbatch
            tk = tokens.reshape(n_micro, microbatch, *tokens.shape[1:])
            lb = labels.reshape(n_micro, microbatch, *labels.shape[1:])
            em = (embeds.reshape(n_micro, microbatch, *embeds.shape[1:])
                  if embeds is not None else None)
            loss, grads = grads_of(params, leaves, tk[0], lb[0],
                                   em[0] if em is not None else None)
            # the accumulator starts from the first microbatch's
            # gradients, as the JAX step seeds its scan
            grads = [g.float() / n_micro for g in grads]
            loss = loss / n_micro
            for i in range(1, n_micro):
                li, gi = grads_of(params, leaves, tk[i], lb[i],
                                  em[i] if em is not None else None)
                for a, g in zip(grads, gi):
                    a.add_(g.float() / n_micro)
                loss = loss + li / n_micro
                del gi
        gnorm = global_norm(grads)
        _, new_opt = optimizer.update(grads, opt_state, leaves, gnorm=gnorm)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": new_opt.step}
        return params, new_opt, metrics

    return train_step


# --------------------------------------------------------------------------- #
#  the train step across ranks
# --------------------------------------------------------------------------- #

#: ``lm_loss``'s z-loss weight (the JAX train step's default)
Z_LOSS = 1e-4
#: a first Adam update this large (of lr) comes from a gradient clear of
#: eps: ``reference_diffs`` holds those elements apart
CLEAR_UPDATE = 0.99
#: ``reference_diffs`` reports the parameters further than this (of lr)
#: from the reference's, with their gradients
OVER_LR = 0.1


def _data_dim(spec) -> Optional[int]:
    for d, e in enumerate(spec):
        if e is not None and "data" in (e if isinstance(e, tuple) else (e,)):
            return d
    return None


def _replicas(spec, mesh) -> int:
    """How many ranks hold the same part of a leaf under ``spec``."""

    used = 1
    for e in spec:
        used *= S.axis_size(mesh, e)
    return math.prod(mesh.values()) // used


def _pack_psum(tensors: List[torch.Tensor], ax) -> None:
    """Sum ``tensors`` over ``ax`` in place, one collective for all."""

    if not tensors or ax.size == 1:
        return
    flat = psum(torch.cat([t.reshape(-1).float() for t in tensors]), ax)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


def _chunked(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` as (n, elements of chunk i along ``dim``): chunk i's elements
    in row i."""
    return t.movedim(dim, 0).reshape(n, -1)


class RankTrainStep:
    """``jitted_train_step`` on one rank (see the module docstring):
    ``step(batch) -> metrics``, ``batch`` the global {"tokens",
    "labels"[, "embeds"]} on the rank's device (the rank cuts its rows),
    metrics {"loss", "grad_norm", "step"} tensors equal on every rank.
    ``params`` and ``specs`` are ``gspmd.gspmd_params``' under ``style``;
    the parameters are updated in place. Every rank of the world calls it
    together."""

    def __init__(self, cfg: ModelConfig, layout, params: Dict[str, Any],
                 specs: Dict[str, Any], optimizer: Optional[AdamW] = None,
                 *, style: str = "fsdp", moment_specs=None,
                 microbatch: Optional[int] = None,
                 grad_dtype: Optional[str] = "bfloat16",
                 has_embeds: bool = False):
        from .gspmd import GspmdModel

        if style not in ("fsdp", "zero1"):
            raise ValueError(f"style {style!r}: fsdp or zero1")
        self.cfg, self.lay, self.style = cfg, layout, style
        self.opt = optimizer or AdamW()
        self.microbatch, self.has_embeds = microbatch, has_embeds
        self.gdt = getattr(torch, grad_dtype) if grad_dtype else None
        self.paths = list(params)
        self.leaves = [params[p].requires_grad_(True) for p in self.paths]
        self.specs = specs
        self.mspecs = dict(specs) if style == "fsdp" else moment_specs
        if self.mspecs is None:
            raise ValueError("zero1 needs the moments' specs "
                             "(zero1_moment_shardings)")
        self.model = GspmdModel(cfg, layout, params, specs)
        self.parts = [self._part(p, t) for p, t in zip(self.paths,
                                                      self.leaves)]
        #: the moments come at the first update (``init_state``): the
        #: card need not hold them beside a step's gradients
        self.state: Optional[AdamState] = None

    def init_state(self) -> AdamState:
        """AdamW's zero state over the rank's parts (f32 moments shaped
        like each leaf's moment part, an int32 step)."""
        if self.state is None:
            dev = self.leaves[0].device
            zeros = [torch.zeros(t.shape, dtype=torch.float32, device=dev)
                     for t in self.parts]
            self.state = AdamState(
                step=torch.zeros((), dtype=torch.int32, device=dev),
                mu=zeros, nu=[z.clone() for z in zeros])
        return self.state

    def _split_dim(self, path: str) -> Optional[int]:
        """zero1: the dimension "data" splits in the moment (None: the
        moment is whole over "data")."""
        if self.style == "fsdp":
            return None
        return _data_dim(self.mspecs[path])

    def _part(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """The part of a leaf this rank updates: the leaf (fsdp), or its
        chunk of the moment's "data" split (zero1), a view."""
        d = self._split_dim(path)
        if d is None:
            return t.detach()
        n = t.shape[d] // self.lay.n_stages
        return t.detach().narrow(d, self.lay.stage * n, n)

    def _loss(self, tokens, labels, embeds):

        m = self.model
        logits = m.forward(tokens, None, embeds=embeds)
        if embeds is not None and self.cfg.family != "audio":
            logits = logits[:, embeds.shape[1]:]
        logits = logits.float()
        lab = labels.long()
        if m.vocab_split():
            ax = m.ax
            top = pmax(logits.detach().amax(-1), ax)
            logz = top + torch.log(tp_sum(
                torch.exp(logits - top[..., None]).sum(-1), ax))
            v_loc = logits.shape[-1]
            off = ax.index * v_loc
            ok = (lab >= off) & (lab < off + v_loc)
            g = logits.gather(-1, (lab - off).clamp(0, v_loc - 1)[..., None])
            gold = tp_sum(torch.where(ok, g[..., 0], 0.0), ax)
        else:
            logz = torch.logsumexp(logits, -1)
            gold = logits.gather(-1, lab[..., None])[..., 0]
        return (logz - gold).mean() + Z_LOSS * logz.square().mean()

    def _grads(self, tokens, labels, embeds, share: float):
        loss = self._loss(tokens, labels, embeds)
        grads = torch.autograd.grad(loss * share, self.leaves,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.leaves, grads)]
        if self.gdt is not None:
            grads = [g.to(self.gdt) for g in grads]
        return loss.detach() * share, grads

    def _rows(self, B: int, start: int) -> slice:
        from .gspmd import batch_rows

        r = batch_rows(self.lay, B)
        return slice(start + r.start, start + r.stop)

    def _sync(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients summed over the batch axes, in each leaf's moment
        layout. zero1 packs them in host memory, where the collective
        stages them anyway, dropping each leaf's gradient as it is packed,
        so the card never holds the gradients twice."""
        lay = self.lay
        data, pod = lay.ring, lay.pods_axis
        if self.style == "fsdp":
            # leaves sharded over "data" were reduce-scattered in the
            # backward; the rest sum here
            _pack_psum([g for p, g in zip(self.paths, grads)
                        if _data_dim(self.specs[p]) is None], data)
            _pack_psum(grads, pod)
            return grads
        split = [self._split_dim(p) for p in self.paths]
        whole = [g for g, d in zip(grads, split) if d is None]
        _pack_psum(whole, data)
        out = [g if d is None else None for g, d in zip(grads, split)]
        idx = [i for i, d in enumerate(split) if d is not None]
        if idx:
            n = data.size
            shapes = {i: (list(grads[i].shape), grads[i].dtype) for i in idx}
            sizes = [grads[i].numel() // n for i in idx]
            dev = grads[idx[0]].device
            packed = torch.empty((n, sum(sizes)), dtype=torch.float32)
            off = 0
            for i, k in zip(idx, sizes):
                packed[:, off:off + k] = _chunked(grads[i].float(), split[i],
                                                  n)
                grads[i] = None
                off += k
            mine = reduce_scatter(packed, data, 0)[0].to(dev)
            del packed
            off = 0
            for i, k in zip(idx, sizes):
                shape, dt = shapes[i]
                d = split[i]
                shape[d] //= n
                moved = [shape[d]] + shape[:d] + shape[d + 1:]
                out[i] = mine[off:off + k].view(moved).movedim(0, d).to(dt)
                off += k
        _pack_psum(out, pod)
        return out

    def _gather_params(self) -> None:
        """zero1: every rank's updated part back into each leaf, one
        all-gather over "data" (packed and gathered in host memory)."""
        data = self.lay.ring
        idx = [i for i, p in enumerate(self.paths)
               if self._split_dim(p) is not None]
        if not idx or data.size == 1:
            return
        flat = torch.cat([self.parts[i].reshape(-1).float().cpu()
                          for i in idx])
        every = all_gather(flat, data)                   # (n, N), host
        off = 0
        for i in idx:
            part, leaf = self.parts[i], self.leaves[i]
            d, k = self._split_dim(self.paths[i]), self.parts[i].numel()
            n = part.shape[d]
            with torch.no_grad():
                for j in range(data.size):
                    leaf.narrow(d, j * n, n).copy_(
                        every[j, off:off + k].view(part.shape))
            off += k

    def _norm(self, grads: List[torch.Tensor]) -> torch.Tensor:

        sq = sum(g.float().square().sum() / _replicas(self.mspecs[p],
                                                      self.lay.mesh)
                 for p, g in zip(self.paths, grads))
        for ax in (self.lay.model, self.lay.ring, self.lay.pods_axis):
            sq = psum(sq, ax)
        return torch.sqrt(sq)

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:

        lay = self.lay
        tokens, labels = batch["tokens"], batch["labels"]
        embeds = batch.get("embeds") if self.has_embeds else None
        B = tokens.shape[0]
        mb = self.microbatch
        n_micro = 1 if mb is None or B <= mb else B // mb
        mb = B // n_micro
        # each batch-axis rank's mean over its rows, weighted by one over
        # the ranks that share the batch: the sum over them is the
        # global mean (replicated rows count once a replica)
        share = 1.0 / (lay.pods * lay.n_stages * n_micro)
        loss, grads = None, None
        for e in range(n_micro):
            r = self._rows(mb, e * mb)
            li, gi = self._grads(tokens[r], labels[r],
                                 None if embeds is None else embeds[r],
                                 share)
            if grads is None:
                loss = li
                grads = [g.float() for g in gi] if n_micro > 1 else gi
            else:
                loss = loss + li
                for a, g in zip(grads, gi):
                    a.add_(g.float())
            del gi
        grads = self._sync(grads)
        for ax in (lay.ring, lay.pods_axis):
            loss = psum(loss, ax)
        gnorm = self._norm(grads)
        _, self.state = self.opt.update(grads, self.init_state(),
                                        self.parts, gnorm=gnorm)
        del grads
        if self.style == "zero1":
            self._gather_params()
        return {"loss": loss, "grad_norm": gnorm, "step": self.state.step}


def rank_train_state(tree, cfg: ModelConfig, layout, *, style: str = "fsdp"):
    """Rank ``layout``'s parameters, their specs and (zero1) the moments'
    specs, from the one-device tree ``tree`` (the JAX layout)."""
    from .gspmd import gspmd_params

    params, specs = gspmd_params(tree, cfg, layout, style=style)
    mspecs = None
    if style == "zero1":
        mspecs = {p: sh.spec for p, sh in S.zero1_moment_shardings(
            cfg, layout.mesh, tree).items()}
    return params, specs, mspecs


def reference_diffs(step: RankTrainStep, tree, reference) -> Dict:
    """A rank's parts after one step from a zero optimizer state against
    the one-device step's, compared on the host a leaf at a time, so a
    large model's parts need not travel back. ``tree``: the one-device
    weights the step started from; ``reference``: (parameters, first
    moment) trees the step should reach. Returns

      * ``max_param_diff``: the largest |Δ| of a parameter;
      * ``max_param_diff_clear``: the same over the elements whose
        reference update is at least ``CLEAR_UPDATE`` of lr. Adam's first
        update lr g / (|g| + eps) (no weight decay) is that large only
        where the gradient is clear of eps (|g| >= 99 eps); elsewhere it
        turns any rounding of g into a sizeable part of lr;
      * ``mu_diff``: {leaf: (max|Δ|, max|ref|)} of the rank's first moment
        part, (1 - b1) g, which that amplification does not enter;
      * ``param_over``: {leaf: {"n", "max_lr", "g_eps", "g_eps_max"}} for
        the leaves with elements beyond ``OVER_LR`` of lr: how many, the
        largest (of lr), that element's reference |g| and the largest
        |g| among them, in units of eps; only the first replica of a part
        reports it, so the counts sum over the ranks;
      * ``compare_s``: the seconds this comparison took."""
    from .gspmd import _load
    from .telemetry import clock

    t0 = clock()
    lay, opt = step.lay, step.opt
    ref, mref = (dict(S.flatten_with_path(_load(t))) for t in reference)
    init = dict(S.flatten_with_path(tree))
    lr = float(opt.schedule(torch.ones((), dtype=torch.int32)))

    def part(t, spec):
        return S.local_shard(t, spec, lay.mesh, lay.coords).float().cpu()

    def fresh(t):
        # an f32 copy on the host, changed in place below
        return t.detach().to("cpu", torch.float32, copy=True)
    worst = clear = 0.0
    mu, over = {}, {}
    for q, t, m in zip(step.paths, step.leaves, step.state.mu):
        spec = step.specs[q]
        want = part(ref[q], spec)
        d = fresh(t).sub_(want).abs_()
        moved = fresh(S.local_shard(init[q], spec, lay.mesh, lay.coords)) \
            .sub_(want).abs_()
        del want
        worst = max(worst, float(d.max()))
        sel = d[moved >= CLEAR_UPDATE * lr]
        del moved
        if sel.numel():
            clear = max(clear, float(sel.max()))
        used = {a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        first = all(lay.coords[a] == 0 for a in lay.mesh if a not in used)
        big = d > OVER_LR * lr
        if first and bool(big.any()):
            g = part(mref[q], spec)[big].abs() / ((1 - opt.b1) * opt.eps)
            far = d[big]
            k = int(far.argmax())
            over[q] = {"n": int(big.sum()), "max_lr": float(far[k]) / lr,
                       "g_eps": float(g[k]), "g_eps_max": float(g.max())}
        del d, sel, big
        mw = part(mref[q], step.mspecs[q])
        lo, hi = torch.aminmax(mw)
        mu[q] = (float(fresh(m).sub_(mw).abs_().max()),
                 max(-float(lo), float(hi)))
        del mw
    return {"max_param_diff": worst, "max_param_diff_clear": clear,
            "mu_diff": mu, "param_over": over, "compare_s": clock() - t0}


def rank_train_job(ctx, *, cfg: ModelConfig, n_stages: int, tp: int,
                   pods: int = 1, params, batches: List[Dict],
                   style: str = "fsdp", optimizer: Optional[AdamW] = None,
                   microbatch: Optional[int] = None,
                   grad_dtype: Optional[str] = "bfloat16",
                   return_state: bool = True, reference=None) -> Dict:
    """One rank's run of ``RankTrainStep`` (a ``RankWorld`` job): its part
    of the one-device tree ``params`` (a dict or a ``torch.save`` file,
    read mapped), then a step on each global batch of ``batches`` (dicts
    of numpy arrays). Returns the rank's coordinates, each step's
    metrics and seconds, its parameter and moment parts after the steps
    (numpy, by path; ``return_state``), the collectives each step ran
    (``collectives.op_counts``) and, on the card,
    ``max_memory_allocated``. ``reference``: the (parameters, first
    moment) trees one step (``batches`` of one) should reach; the rank
    adds ``reference_diffs``' comparison of its parts with them."""
    from .gspmd import _load, _sync
    from .telemetry import clock

    lay = ctx.layout(n_stages, tp, pods)
    dev = lay.device
    tree = _load(params)
    p, specs, mspecs = rank_train_state(tree, cfg, lay, style=style)
    has_embeds = "embeds" in batches[0]
    step = RankTrainStep(cfg, lay, p, specs, optimizer, style=style,
                         moment_specs=mspecs, microbatch=microbatch,
                         grad_dtype=grad_dtype, has_embeds=has_embeds)
    metrics, secs, counts = [], [], []
    for b in batches:
        batch = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in b.items()}
        reset_op_counts()
        _sync(dev)
        t0 = clock()
        m = step(batch)
        _sync(dev)
        secs.append(clock() - t0)
        counts.append(op_counts())
        metrics.append({k: float(v) for k, v in m.items()})

    def host(t):
        return t.detach().float().cpu().numpy().copy()
    out = {"rank": ctx.rank, "pod": lay.pod, "stage": lay.stage,
           "member": lay.member, "metrics": metrics, "step_s": secs,
           "collectives": counts}
    if return_state:
        out.update(
            params={q: host(t) for q, t in zip(step.paths, step.leaves)},
            mu={q: host(t) for q, t in zip(step.paths, step.state.mu)},
            nu={q: host(t) for q, t in zip(step.paths, step.state.nu)})
    if reference is not None:
        out.update(reference_diffs(step, tree, reference))
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out
