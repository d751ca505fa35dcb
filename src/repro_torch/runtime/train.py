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
plain chunked attention, as in the reference). The JAX package's
``jitted_train_step`` binds mesh shardings and has no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..models import model as M
from ..quant.grouped import QuantizedTensor
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
