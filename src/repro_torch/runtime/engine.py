"""Continuous-batching serving engine of the port.

Counterpart of ``repro.runtime.engine``: fixed B decode slots; arriving
requests are prefilled and placed in free slots; finished sequences free
their slot at once. Over a paged cache (``kv``) admission reserves pages
(prefix-sharing identical prompt prefixes), every step grows and
copy-on-writes the write range first, and ``prefill_chunk`` admits a
prompt chunk by chunk with one decode step for the active slots between
chunks.

A ``source`` (``runtime.paramstore.ParamSource``, set by
``runtime.streaming.make_streaming_engine``) is the weight source the
layer-wise prefill and decode pull from; the engine keeps it for
``streaming_stats()``. ``spec`` (a ``runtime.speculative.SpeculativeDecoder``)
turns each step into one draft/verify cycle: every occupied slot advances
by 1 to gamma + 1 tokens, and the streams stay equal to vanilla greedy
decode. Session parking, the span tracer and serving metrics are later
slices; passing any of them raises ``NotImplementedError``. In their place
the engine stamps each request's first-token and finish times on
``clock`` (TTFT and TPOT on ``FinishedRequest``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .telemetry import clock

_LATER = {"session": "session parking (ROADMAP Queue A item 8)",
          "tracer": "the span tracer (ROADMAP Queue A item 7)",
          "metrics": "serving metrics (ROADMAP Queue A item 7)"}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}= is not ported yet: {_LATER[what]}")


@dataclasses.dataclass
class SlotState:
    uid: Optional[int] = None        # request id (None = free)
    remaining: int = 0               # tokens still to generate
    generated: Optional[List[int]] = None
    t_first: float = 0.0             # clock() when the first token existed
    proposed: int = 0                # draft tokens proposed (speculative)
    accepted: int = 0                # draft tokens accepted (speculative)


@dataclasses.dataclass
class FinishedRequest:
    uid: int
    tokens: List[int]
    ttft_s: float = 0.0              # run start -> first token
    tpot_s: float = 0.0              # mean time per later token
    proposed: int = 0                # speculative bookkeeping (0 = vanilla)
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)


@dataclasses.dataclass
class RejectedRequest:
    """A request the engine shed instead of admitting: ``shed_capacity``
    (even an empty pool could never hold it) or ``deferred_ttl_expired``
    (admission starved past the deferral TTL)."""

    uid: int
    reason: str
    code: str = "shed_capacity"


class ContinuousBatcher:
    """Slot-multiplexed decode over a fixed-width batch.

    prefill_one(prompt (1,S)) -> (first_token int, slot_cache)
    write_slot(cache, slot_cache, slot_idx, length) -> cache
    decode(cache, tokens (B,1)) -> (logits (B,1,V), cache)

    ``source``: the ``ParamSource`` the callables pull weights from
    (kept for ``streaming_stats()``). ``ctx``: the dense cache's
    ``max_len`` (admit rejects a request whose
    ``len(prompt) + max_new`` cannot fit). ``kv``: a
    ``runtime.kvcache.PagedKVCache``; ``decode`` is then the paged step.
    ``prefill_chunk``/``chunk_step(view, tokens, write)``: chunked paged
    admission. ``spec``: a ``SpeculativeDecoder``; it owns the draft cache
    (``spec.admit`` prefills a slot of it), and paged admission reserves
    gamma positions past the budget, which a verify pass writes before
    its rollback.
    """

    def __init__(self, batch: int, prefill_one: Callable,
                 write_slot: Callable, decode: Callable,
                 *, eos_id: Optional[int] = None, spec=None, source=None,
                 ctx: Optional[int] = None, kv=None, tracer=None,
                 metrics=None, prefill_chunk: Optional[int] = None,
                 chunk_step: Optional[Callable] = None, device="cuda"):
        for name, val in (("tracer", tracer), ("metrics", metrics)):
            if val is not None:
                raise _not_ported(name)
        self.B = batch
        self.prefill_one = prefill_one
        self.write_slot = write_slot
        self.decode = decode
        self.eos_id = eos_id
        self.spec = spec
        self.source = source
        self.ctx = ctx
        self.kv = kv
        self.prefill_chunk = prefill_chunk
        self.chunk_step = chunk_step
        self.device = torch.device(device)
        if prefill_chunk is not None and (kv is None or chunk_step is None):
            raise ValueError("prefill_chunk requires a paged cache (kv) and "
                             "a chunk_step callable")
        self.slots = [SlotState() for _ in range(batch)]
        self.finished: List[FinishedRequest] = []
        self.rejected: List[RejectedRequest] = []
        self._t_start = clock()

    # ------------------------------------------------------------------ #

    def streaming_stats(self):
        """Prefetch statistics of the attached streaming source (or
        None)."""
        if self.source is not None and hasattr(self.source, "stats"):
            return self.source.stats()
        return None

    @property
    def _margin(self) -> int:
        """Positions a verify pass writes past a request's budget."""
        return self.spec.gamma if self.spec is not None else 0

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.uid is None]

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.uid is not None]

    def admit(self, cache, tokens: torch.Tensor, uid: int,
              prompt: np.ndarray, max_new: int,
              session: Optional[str] = None):
        """Prefill ``prompt`` and place it in a free slot. Dense caches
        validate ``len(prompt) + max_new`` against ``ctx``; the paged path
        allocates on demand and raises ``PoolExhausted`` when the pool
        cannot hold the request now."""
        if session is not None:
            raise _not_ported("session")
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots")
        slot = free[0]
        prompt = np.asarray(prompt)
        prompt_t = torch.as_tensor(prompt, device=self.device)[None, :]
        if self.kv is not None and self.prefill_chunk is not None:
            self.kv.plan_admit(cache, slot, [int(t) for t in prompt],
                               max_new + self._margin, register=False)
            try:
                cache, tokens, first_tok = self._chunked_prefill(
                    cache, tokens, slot, prompt)
            except BaseException:
                self.kv.abort_admit(slot)      # no leaked planned pages
                raise
        elif self.kv is not None:
            self.kv.plan_admit(cache, slot, [int(t) for t in prompt],
                               max_new + self._margin)
            try:
                first_tok, slot_cache = self.prefill_one(prompt_t)
                cache = self.kv.install(cache, slot, slot_cache["layers"],
                                        len(prompt))
            except BaseException:
                self.kv.abort_admit(slot)
                raise
        else:
            if self.ctx is not None and len(prompt) + max_new > self.ctx:
                raise ValueError(
                    f"request {uid}: prompt ({len(prompt)}) + max_new "
                    f"({max_new}) exceeds the cache context ({self.ctx}); "
                    f"the preallocated cache would silently clip — raise "
                    f"ctx or trim the request")
            first_tok, slot_cache = self.prefill_one(prompt_t)
            cache = self.write_slot(cache, slot_cache, slot, len(prompt))
        if self.spec is not None:
            self.spec.admit(prompt_t, slot, len(prompt))
        tokens[slot, 0] = first_tok
        self.slots[slot] = SlotState(uid=uid, remaining=max_new - 1,
                                     generated=[int(first_tok)],
                                     t_first=clock())
        return cache, tokens

    def _chunked_prefill(self, cache, tokens, slot: int, prompt: np.ndarray):
        """Admit one prompt in page-aligned chunks computed straight into
        the slot's planned pages, one decode step for the active slots
        between chunks. Leading prefix-shared pages are skipped; a fully
        shared prompt re-derives its last logits read-only. Returns
        ``(cache, tokens, first_token)``."""
        kv = self.kv
        S = len(prompt)
        cache, skip = kv.begin_chunked_admit(cache, slot, S)
        table1 = torch.as_tensor(kv.chunk_table(slot), device=self.device)
        o, write = skip, True
        if skip >= S:
            o, write = S - 1, False
        logits = None
        while o < S:
            c = min(self.prefill_chunk, S - o)
            view = {"pages": cache["pages"], "block_table": table1,
                    "len": torch.full((1,), o, dtype=torch.int32,
                                      device=self.device)}
            chunk = torch.as_tensor(prompt[o:o + c], device=self.device)
            logits, _ = self.chunk_step(view, chunk[None, :], write)
            o += c
            if o < S and self.active():
                cache, tokens = self.step(cache, tokens)
        first_tok = int(torch.argmax(logits[0, -1]))
        cache = kv.finish_chunked_admit(cache, slot, S)
        return cache, tokens, first_tok

    def _finish(self, i: int, cache):
        st = self.slots[i]
        now = clock()
        n_later = len(st.generated) - 1
        self.finished.append(FinishedRequest(
            uid=st.uid, tokens=st.generated,
            ttft_s=st.t_first - self._t_start,
            tpot_s=(now - st.t_first) / n_later if n_later else 0.0,
            proposed=st.proposed, accepted=st.accepted))
        self.slots[i] = SlotState()                      # free immediately
        if self.kv is not None:
            self.kv.release_slot(i)
        return cache

    def step(self, cache, tokens: torch.Tensor):
        """One greedy decode step (or one draft/verify cycle) for every
        occupied slot."""
        if self.spec is not None:
            return self._spec_step(cache, tokens)
        if self.kv is not None:
            cache = self.kv.begin_step(cache, self.active(), 1)
        logits, cache = self.decode(cache, tokens)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        nxt_host = nxt.cpu().numpy()                     # the step's sync
        tokens = nxt[:, None].to(tokens.dtype)
        for i in self.active():
            st = self.slots[i]
            tok = int(nxt_host[i])
            if self.kv is not None:
                self.kv.advance(i)
            st.generated.append(tok)
            st.remaining -= 1
            if st.remaining <= 0 or (self.eos_id is not None
                                     and tok == self.eos_id):
                cache = self._finish(i, cache)
        return cache, tokens

    def _spec_step(self, cache, tokens: torch.Tensor):
        """One draft/verify cycle: every occupied slot advances by 1 to
        gamma + 1 tokens. Tokens emitted past a slot's budget or past EOS
        are dropped, and the slot frees at once, as in vanilla decode."""
        len0 = {}
        if self.kv is not None:
            # the verify pass writes gamma + 1 positions before rollback
            cache = self.kv.begin_step(cache, self.active(),
                                       self.spec.gamma + 1)
            len0 = {i: self.kv.length(i) for i in self.active()}
        cache, res = self.spec.cycle(cache, tokens, active=self.active())
        tokens = res.next_tokens.to(tokens.dtype)
        for i in self.active():
            st = self.slots[i]
            n = int(res.n_emit[i])
            if self.kv is not None:
                # pages past the accepted length return to the pool: the
                # allocator half of the rollback (len is already reset)
                self.kv.trim_to(i, len0[i] + n)
            # the counters sample draft/target agreement, so drafts that
            # were verified but dropped past the budget still count
            st.proposed += self.spec.gamma
            st.accepted += n - 1
            for tok in res.emitted[i, :n]:
                tok = int(tok)
                st.generated.append(tok)
                st.remaining -= 1
                if st.remaining <= 0 or (self.eos_id is not None
                                         and tok == self.eos_id):
                    cache = self._finish(i, cache)
                    break
        return cache, tokens

    def run(self, cache, requests, *, max_steps: int = 10_000,
            admit_patience: int = 256):
        """Drive a request list to completion; returns (finished, steps).

        On the paged path a transiently exhausted pool defers the admit
        until finishes free pages; it propagates only when no active slot
        could ever free any. A request an *empty* pool could not hold, or
        whose admit was refused ``admit_patience`` consecutive steps, is
        shed onto ``self.rejected``.
        """
        from .kvcache import PoolExhausted

        tokens = torch.zeros((self.B, 1), dtype=torch.int32,
                             device=self.device)
        pending = list(requests)
        deferrals: Dict[int, int] = {}
        steps = 0
        self._t_start = clock()
        while (pending or self.active()) and steps < max_steps:
            while pending and self.free_slots():
                req = pending.pop(0)
                try:
                    cache, tokens = self.admit(
                        cache, tokens, req.uid, req.prompt,
                        req.max_new_tokens,
                        session=getattr(req, "session", None))
                    deferrals.pop(req.uid, None)
                except PoolExhausted as e:
                    if not self.active():
                        raise              # nothing will ever free pages
                    if self.kv is not None and not self.kv.can_ever_admit(
                            len(req.prompt),
                            req.max_new_tokens + self._margin):
                        self._shed(req.uid, "shed_capacity",
                                   f"pool too small for request "
                                   f"{req.uid}: {e}")
                        continue
                    n = deferrals.get(req.uid, 0) + 1
                    if n > admit_patience:
                        deferrals.pop(req.uid, None)
                        self._shed(req.uid, "deferred_ttl_expired",
                                   f"pool too small for request "
                                   f"{req.uid}: admission deferred "
                                   f"{n - 1} consecutive steps without "
                                   f"a slot freeing enough pages ({e})")
                        continue
                    deferrals[req.uid] = n
                    pending.insert(0, req)
                    break
            if self.active():
                cache, tokens = self.step(cache, tokens)
            steps += 1
        return self.finished, steps

    def _shed(self, uid: int, code: str, reason: str) -> None:
        self.rejected.append(RejectedRequest(uid=uid, reason=reason,
                                             code=code))


def write_dense_slot(cache, slot_cache, slot: int, length: int):
    """Copy a one-sequence dense cache (a prefill's) into ``slot`` of the
    batch cache, in place."""
    for name, dst in cache["layers"].items():
        dst[:, slot] = slot_cache["layers"][name][:, 0]
    cache["len"][slot] = slot_cache["len"][0]
    return cache


def make_dense_engine(params, cfg, batch: int, ctx: int, *,
                      eos_id: Optional[int] = None, spec=None,
                      cache_dtype=torch.float32,
                      device="cuda") -> ContinuousBatcher:
    """Reference dense-cache engine (prefill-one / slot-write / decode over
    ``models.decode_step``). Drive it with
    ``eng.run(init_cache(cfg, batch, ctx, dtype, device), reqs)``.
    ``spec``: a ``SpeculativeDecoder`` whose ``verify`` is the target's
    ``decode_step``."""
    from ..models import model as M

    def prefill_one(prompt):
        c1 = M.init_cache(cfg, 1, ctx, dtype=cache_dtype, device=device)
        logits, c1 = M.prefill(params, cfg, prompt, c1)
        return int(torch.argmax(logits[0, -1])), c1

    def decode(cache, tokens):
        return M.decode_step(params, cfg, cache, tokens)

    return ContinuousBatcher(batch, prefill_one, write_dense_slot, decode,
                             eos_id=eos_id, spec=spec, ctx=ctx,
                             device=device)
