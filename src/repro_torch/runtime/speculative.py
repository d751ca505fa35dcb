"""Speculative decoding of the port: the greedy draft/verify loop over two
model stacks (``repro.runtime.speculative``).

A small *draft* model proposes ``gamma`` tokens one at a time; the target
then scores all ``gamma + 1`` positions (the pending token followed by the
drafts) in ONE multi-token verify pass (``models.decode_step`` and its
paged and layer-wise forms at T = gamma + 1, attention through kernel B5
or B1 on the card). The streamed verify pass reads each layer's weights
once for the whole block, which is why speculation pays where weights
stream.

Greedy acceptance keeps the emitted stream equal to plain greedy decode of
the target: drafts are accepted while they match the target's argmax, and
the first mismatch is replaced by the target's own token, so every cycle
emits between 1 and gamma + 1 tokens. Rejected positions roll back by
resetting the per-slot ``len`` counter (``models.rollback_cache``):
entries past ``len`` are position-masked and the next write lands at
``len``.

The port's caches are written in place, lengths included, so the lengths
before a cycle are cloned, not kept as views of a counter a later write
could change. The draft's step and the verify pass may be graphed steps
(``runtime.engine.GraphedDecode``): each cycle reads their logits before
their next replay, and the rollback writes the cache's own ``len``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.latency import expected_tokens_per_cycle  # noqa: F401  (re-export)
from ..models.model import rollback_cache


@dataclasses.dataclass
class SpecCycleResult:
    """Host-side view of one draft/verify cycle."""

    next_tokens: torch.Tensor    # (B, 1) new pending token per slot
    emitted: np.ndarray          # (B, gamma+1) emitted tokens (row-padded)
    n_emit: np.ndarray           # (B,) valid prefix of ``emitted`` (>= 1)

    @property
    def n_accepted(self) -> np.ndarray:
        return self.n_emit - 1


class SpeculativeDecoder:
    """Drives a draft model against a target verify function.

    draft_decode(d_cache, tokens (B, 1)) -> (logits (B, 1, V), d_cache)
    verify(t_cache, tokens (B, T))       -> (logits (B, T, V), t_cache)

    Both caches carry a per-sequence ``len`` counter (the only thing the
    rollback touches). The decoder owns the draft-side cache and its
    prefill/slot plumbing, so the serving engine threads only the target
    cache through, as in vanilla decode. ``vocab``: the true vocabulary
    size when a model function returns padded logits (a pad column would
    otherwise win the argmax whenever every real logit is negative).
    """

    def __init__(self, draft_decode: Callable, verify: Callable, *,
                 gamma: int = 4,
                 draft_cache: Optional[Dict] = None,
                 draft_prefill_one: Optional[Callable] = None,
                 draft_write_slot: Optional[Callable] = None,
                 vocab: Optional[int] = None):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.draft_decode = draft_decode
        self.verify = verify
        self.gamma = gamma
        self.draft_cache = draft_cache
        self.draft_prefill_one = draft_prefill_one
        self.draft_write_slot = draft_write_slot
        self.vocab = vocab
        # aggregate bookkeeping (per-slot counters live in the engine)
        self.cycles = 0
        self.proposed = 0
        self.accepted = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    def admit(self, prompt: torch.Tensor, slot: int, length: int) -> None:
        """Prefill the draft cache for a newly admitted request."""
        if self.draft_prefill_one is None:
            return
        _, slot_cache = self.draft_prefill_one(prompt)
        self.draft_cache = self.draft_write_slot(self.draft_cache,
                                                 slot_cache, slot, length)

    def _trim(self, logits: torch.Tensor) -> torch.Tensor:
        return logits if self.vocab is None else logits[..., :self.vocab]

    def cycle(self, t_cache: Dict, tokens: torch.Tensor, active=None
              ) -> Tuple[Dict, SpecCycleResult]:
        """One draft/verify cycle for the whole batch.

        ``tokens``: (B, 1) pending token per slot, emitted already but in
        neither cache. ``active``: optional iterable of occupied slots;
        only those rows feed the aggregate counters (free slots decode
        junk). Returns the rolled-back target cache and the emitted block;
        the draft cache is updated in place.
        """
        B = tokens.shape[0]
        g = self.gamma
        d_cache = self.draft_cache
        t_len0 = t_cache["len"].clone()
        d_len0 = d_cache["len"].clone()

        # draft gamma tokens; one extra step banks the last draft's KV so a
        # fully accepted cycle leaves the draft cache complete
        drafts = []
        cur = tokens
        for _ in range(g):
            lg, d_cache = self.draft_decode(d_cache, cur)
            cur = torch.argmax(self._trim(lg)[:, -1], -1)[:, None].to(
                tokens.dtype)
            drafts.append(cur)
        _, d_cache = self.draft_decode(d_cache, cur)
        draft_blk = torch.cat(drafts, dim=1)                  # (B, g)

        # one multi-token verify pass on the target
        ver_in = torch.cat([tokens, draft_blk], dim=1)        # (B, g+1)
        logits, t_cache = self.verify(t_cache, ver_in)
        tgt = torch.argmax(self._trim(logits), -1).to(tokens.dtype)

        # greedy acceptance: the longest prefix where draft == target
        # (argmin over an int tensor: torch's argmin takes no bool)
        ok = (draft_blk == tgt[:, :-1]).to(torch.int32)       # (B, g)
        n_acc = torch.argmin(F.pad(ok, (0, 1), value=0), dim=1)
        corr = tgt.gather(1, n_acc[:, None])                  # (B, 1)
        idx = torch.arange(g + 1, device=tokens.device)[None, :]
        emitted = torch.where(idx == n_acc[:, None], corr,
                              F.pad(draft_blk, (0, 1)))

        # rollback: keep the pending token and the accepted drafts
        t_cache = rollback_cache(t_cache, t_len0 + n_acc + 1)
        self.draft_cache = rollback_cache(d_cache, d_len0 + n_acc + 1)

        n_emit = n_acc.cpu().numpy() + 1
        rows = list(active) if active is not None else range(int(B))
        self.cycles += 1
        self.proposed += len(rows) * g
        self.accepted += int(sum(n_emit[i] for i in rows)) - len(rows)
        return t_cache, SpecCycleResult(next_tokens=corr,
                                        emitted=emitted.cpu().numpy(),
                                        n_emit=n_emit)
