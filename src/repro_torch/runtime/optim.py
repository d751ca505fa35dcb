"""AdamW with global-norm clipping: ``repro.runtime.optim`` over the
port's trainable leaves.

The JAX optimizer maps over a pytree; here ``params``, ``grads`` and the
moments are lists of tensors in one order (``runtime.train.trainable``:
the model's ``parameters()``). The semantics are the JAX package's, not
``torch.optim.AdamW``'s: f32 moments whatever the parameter's dtype,
global-norm clipping of the gradients before the moments, bias correction
by ``1 - b^t``, the linear warmup ``lr * min(step / warmup, 1)``, weight
decay added to the update (not decoupled), the update computed in f32
and cast back to the parameter's dtype. The step counter and every
scalar derived from it stay on the device, so a step reads nothing back
to the host. Moments and parameters are updated in place, the
counterpart of the JAX step's donated buffers.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


class AdamState(NamedTuple):
    """step: () int32; mu, nu: f32 tensors, one for each leaf (the JAX
    ``AdamState``'s fields, in its order)."""
    step: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        params = list(params)
        dev = params[0].device if params else None
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params]
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=zeros, nu=[z.clone() for z in zeros])

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (a tensor): f32, on its device."""
        warm = torch.clamp(step.float() / max(self.warmup_steps, 1),
                           max=1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor], *,
               gnorm: Optional[torch.Tensor] = None
               ) -> Tuple[List[torch.Tensor], AdamState]:
        """One step: ``params`` and the moments are written in place and
        returned with the advanced step. ``gnorm``: ``global_norm(grads)``
        if the caller has it already."""
        step = state.step + 1
        scale = None
        if self.clip_norm is not None:
            if gnorm is None:
                gnorm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm,
                                                             min=1e-12),
                                max=1.0)
        b1, b2 = self.b1, self.b2
        t = step.float()
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, t))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, t))
        lr = self.schedule(step)
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            # clipped in f32, as jnp promotes a bf16 gradient by the f32
            # scale
            g = g.float() if scale is None else g.float() * scale
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square().mul_(1 - b2))
            u = (m * mu_hat_scale).div_((v * nu_hat_scale).sqrt_()
                                        .add_(self.eps))
            if self.weight_decay:
                u.add_(p.float() * self.weight_decay)
            u.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(u)
            else:
                p.copy_((p.float() - u).to(p.dtype))
        return list(params), AdamState(step=step, mu=state.mu, nu=state.nu)


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))
