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
decode.

Instrumentation takes the JAX engine's call sites: each step is one
``tracer.token_step`` whose ``compute`` phase holds the decode call and
its host sync (so the component is the device's time as the host waits
for it), ``admit[...]`` and ``prefill-chunk[...]`` spans, ``reject[...]``
instants and the ``spec/proposed``/``spec/accepted`` counters; a
``metrics`` registry gets the request lifecycle (``RequestTracker``) and
the engine's gauges. A request's ``session`` names a multi-turn
conversation on a parking-enabled paged cache: at finish the slot's KV
parks under it, and the session's next admit restores it and continues
decoding. The engine also stamps each request's first-token and finish
times on ``clock`` (TTFT and TPOT on ``FinishedRequest``).

``StepGraphs`` is the port's counterpart of the JAX package's jitted
steps: the builders (``make_dense_engine`` here, ``make_paged_engine`` and
``make_streaming_engine``) replay their fixed-shape decode steps from CUDA
graphs on the card (``graphs=True``, the default).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from collections import Counter
from typing import Callable, Dict, Hashable, List, Optional

import numpy as np
import torch

from ..kernels import _build, ops
from .iopolicy import BudgetExceeded
from .telemetry import clock, resolve_tracer

# --------------------------------------------------------------------------- #
#  the compiled step: CUDA graphs of fixed-shape steps
# --------------------------------------------------------------------------- #

def _set_launches(counts: Dict[str, int]) -> None:
    """Put ``_build.LAUNCHES`` back to ``counts`` (keys added since count
    from 0)."""
    for k in list(_build.LAUNCHES):
        _build.LAUNCHES[k] = counts.get(k, 0)


class StepGraphs:
    """CUDA graphs of fixed-shape steps, by key, in one memory pool.

    ``run(key, body, scrub)`` returns ``body()``'s outputs, replayed from
    the graph captured for ``key``. ``body`` must read and write only
    static tensors (the same addresses at every call: the callers copy
    their inputs into static buffers first) and return tensors, which the
    caller reads before the next replay of any graph of this object (they
    share one pool). A key's graph is captured at its first use: inside
    ``scrub`` (a context manager that points the step's writes at scratch
    -- all-sink block tables, zero lengths -- and restores the live
    values on exit), one warm-up run on a side stream, then the capture.
    A capture that fails raises: there is no eager fallback.

    A replay runs no Python kernel wrapper, so the kernel launches that
    the capture recorded in ``_build.LAUNCHES`` are added on every replay;
    the warm-up's and the capture's own are taken back.

    On the CPU no graph exists: ``body`` runs at every replay, on the same
    static buffers (the first run inside ``scrub``, as a capture), with
    the same launch accounting. On the card with the kernels forced off
    (``ops.use_kernels(False)``) it raises: the plain versions read
    lengths on the host.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self._probe = torch.empty(0, device=self.device)
        #: key -> (graph or None, outputs, launches a replay adds)
        self._graphs: Dict[Hashable, tuple] = {}
        self.captures = 0
        self.capture_s = 0.0
        #: device memory reserved while capturing (the pool's growth)
        self.pool_bytes = 0
        self.replays: Counter = Counter()

    def reset(self, kind: str) -> None:
        """Drop the graphs of keys ``(kind, ...)``: the static tensors
        they read are gone."""
        for key in [k for k in self._graphs if k[0] == kind]:
            del self._graphs[key]

    def _capture(self, key, body, scrub) -> tuple:
        t0 = time.perf_counter()
        before = dict(_build.LAUNCHES)
        with scrub():
            if not self.on_card:
                out = body()
                graph = None
            else:
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    body()                                   # warm-up
                torch.cuda.current_stream(self.device).wait_stream(side)
                _set_launches(before)
                graph = torch.cuda.CUDAGraph()
                gc.collect()                 # as the capture will, first
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(self.device)
                # thread_local: a prefetcher thread's copies elsewhere in
                # the process do not invalidate the capture
                with torch.cuda.graph(graph, pool=self.pool,
                                      capture_error_mode="thread_local"):
                    out = body()
                self.pool_bytes += (torch.cuda.memory_reserved(self.device)
                                    - reserved)
        delta = {k: n - before.get(k, 0)
                 for k, n in _build.LAUNCHES.items()
                 if n != before.get(k, 0)}
        _set_launches(before)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        ent = self._graphs[key] = (graph, out, delta)
        return ent

    def run(self, key: Hashable, body: Callable, scrub: Callable):
        if self.on_card and not ops.kernels_active(self._probe):
            raise RuntimeError(
                "a graphed step cannot run with ops.use_kernels(False): "
                "the plain versions read lengths on the host; build the "
                "engine with graphs=False")
        ent = self._graphs.get(key)
        if ent is None:
            ent = self._capture(key, body, scrub)
        graph, out, delta = ent
        if graph is None:                  # the CPU: run on static buffers
            before = dict(_build.LAUNCHES)
            out = body()
            _set_launches(before)
        else:
            graph.replay()
        for k, n in delta.items():
            _build.LAUNCHES[k] = _build.LAUNCHES.get(k, 0) + n
        self.replays[key] += 1
        return out


def cache_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a (nested dict) cache, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in cache_tensors(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


@contextlib.contextmanager
def saved(tensors: List[torch.Tensor], *, zero=()):
    """Restore ``tensors`` on exit; ``zero`` are zeroed meanwhile (the
    scrub of a graph capture)."""
    keep = [t.clone() for t in tensors]
    try:
        for t in zero:
            t.zero_()
        yield
    finally:
        for t, k in zip(tensors, keep):
            t.copy_(k)


class GraphedDecode:
    """A decode step ``step(cache, tokens (B, T)) -> (logits, cache)``
    replayed from a CUDA graph per T (``StepGraphs``), over a cache whose
    tensors stay put: ``fn(cache, tokens) -> (logits, new_cache)`` is the
    eager step, whose length update (a new ``len`` tensor) the graph
    writes into the cache's own ``len`` in place, so the cache dict that
    comes back holds the tensors it was given. Tokens are copied into a
    static (B, T) buffer. ``scrub(cache, T)`` makes a capture write only
    scratch (see ``StepGraphs``). A cache of other tensors (a new run)
    drops the graphs and captures anew.
    """

    def __init__(self, fn: Callable, graphs: StepGraphs, scrub: Callable):
        self.fn = fn
        self.graphs = graphs
        self.scrub = scrub
        self.tokens: Dict[int, torch.Tensor] = {}     # T -> static buffer
        self._sig = None

    def __call__(self, cache, tokens: torch.Tensor):
        sig = tuple(t.data_ptr() for t in cache_tensors(cache))
        if sig != self._sig:
            self.graphs.reset("decode")
            self.tokens.clear()
            self._sig = sig
        T = tokens.shape[1]
        tok = self.tokens.get(T)
        if tok is None:
            tok = self.tokens[T] = torch.zeros_like(tokens)
        tok.copy_(tokens)

        def body():
            logits, new = self.fn(cache, tok)
            cache["len"].copy_(new["len"])
            return logits
        logits = self.graphs.run(("decode", T), body,
                                 lambda: self.scrub(cache, T))
        return logits, cache


#: the recurrent leaves of a dense cache (ssm, the hybrid's RG-LRU): a
#: step writes all of them; every other leaf is (L, B, S, ...) lines
RECURRENT_LEAVES = ("conv", "state", "h")


def _cache_leaves(tree, name=None):
    """(leaf name, tensor) of a nested cache tree in a fixed order, its
    top-level ``len`` left out."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            if not (name is None and k == "len"):
                yield from _cache_leaves(tree[k], k)
    else:
        yield name, tree


def dense_scrub(cache, T: int):
    """A dense cache's capture scrub: lengths zero, so a step writes rows
    0..T-1 of every slot's lines (saved and restored) or the whole
    recurrent state (saved and restored), over any cache tree (the
    hybrid family's groups and tail, whisper's cross K/V, which a step
    only reads)."""
    keep = [t if name in RECURRENT_LEAVES else t[:, :, :T]
            for name, t in _cache_leaves(cache)]
    return saved([cache["len"], *keep], zero=[cache["len"]])


def dense_decode(params, cfg, *, graphs: bool = True,
                 device="cuda") -> Callable:
    """``models.decode_step`` over a dense cache as an engine's (or a
    draft's) decode callable: replayed from CUDA graphs (``GraphedDecode``)
    unless ``graphs=False``."""
    from ..models import model as M

    def fn(cache, tokens):
        return M.decode_step(params, cfg, cache, tokens)
    if not graphs:
        return fn
    return GraphedDecode(fn, StepGraphs(device), dense_scrub)


# --------------------------------------------------------------------------- #
#  the batcher
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class SlotState:
    uid: Optional[int] = None        # request id (None = free)
    remaining: int = 0               # tokens still to generate
    generated: Optional[List[int]] = None
    t_first: float = 0.0             # clock() when the first token existed
    t_submit: float = 0.0            # clock() when the request arrived
    proposed: int = 0                # draft tokens proposed (speculative)
    accepted: int = 0                # draft tokens accepted (speculative)
    session: Optional[str] = None    # park the slot's KV under this key


@dataclasses.dataclass
class FinishedRequest:
    uid: int
    tokens: List[int]
    ttft_s: float = 0.0              # arrival (run start) -> first token
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
    its rollback. ``tracer``: a ``telemetry.Tracer``; ``metrics``: a
    ``metrics.MetricsRegistry``. ``graphs``: the builders' ``StepGraphs``
    (for their counts), or None.
    """

    def __init__(self, batch: int, prefill_one: Callable,
                 write_slot: Callable, decode: Callable,
                 *, eos_id: Optional[int] = None, spec=None, source=None,
                 ctx: Optional[int] = None, kv=None, tracer=None,
                 metrics=None, prefill_chunk: Optional[int] = None,
                 chunk_step: Optional[Callable] = None, device="cuda",
                 graphs: Optional[StepGraphs] = None):
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
        self.graphs = graphs
        if prefill_chunk is not None and (kv is None or chunk_step is None):
            raise ValueError("prefill_chunk requires a paged cache (kv) and "
                             "a chunk_step callable")
        self.tracer = resolve_tracer(tracer)
        self.metrics = metrics
        self._tracker = None
        if metrics is not None:
            from .metrics import RequestTracker
            self._tracker = RequestTracker(metrics)
            metrics.add_source("engine", self.sample_gauges)
        self.slots = [SlotState() for _ in range(batch)]
        self.finished: List[FinishedRequest] = []
        self.rejected: List[RejectedRequest] = []
        self._t_start = clock()
        self._submit_t: Dict[int, float] = {}     # uid -> arrival instant
        self._step_idx = 0
        self._queued_n = 0               # pending requests (gauge)
        self._deferred_n = 0             # admits deferred on pool pressure
        self._spec_proposed = 0
        self._spec_accepted = 0

    # ------------------------------------------------------------------ #

    def telemetry(self):
        """The attached tracer (NULL_TRACER when tracing is off)."""
        return self.tracer

    def streaming_stats(self):
        """Prefetch statistics of the attached streaming source (or
        None)."""
        if self.source is not None and hasattr(self.source, "stats"):
            return self.source.stats()
        return None

    def sample_gauges(self) -> Dict[str, float]:
        """Gauge sample for ``MetricsRegistry.add_source``: slot
        occupancy, the queue, speculative acceptance, the block pool's
        pages and prefix-hit rate, the KV offloader's and the streamed
        source's I/O retries, and each memory tier's used and peak bytes
        (the JAX engine's names)."""
        g: Dict[str, float] = {
            "slots/active": float(len(self.active())),
            "slots/free": float(len(self.free_slots())),
            "queue/pending": float(self._queued_n),
            "queue/deferred": float(self._deferred_n),
        }
        if self.spec is not None:
            g["spec/acceptance_rate"] = (
                self._spec_accepted / max(self._spec_proposed, 1))
        if self.kv is not None:
            pool = self.kv.pool
            g["kv/pages_active"] = float(pool.n_active)
            g["kv/pages_free"] = float(pool.n_free)
            g["kv/pages_cached"] = float(pool.n_cached)
            looks = self.kv.prefix_hits + pool.alloc_count
            g["kv/prefix_hit_rate"] = self.kv.prefix_hits / max(looks, 1)
            if self.kv.offloader is not None:
                g["io/kv_retries"] = float(self.kv.offloader.health.retries)
            for tier, st in self.kv.memory.stats().items():
                g[f"mem/{tier}/used_bytes"] = float(st.used)
                g[f"mem/{tier}/peak_bytes"] = float(st.peak)
        src = self.source
        if src is not None and hasattr(src, "health"):
            g["io/stream_retries"] = float(src.health.retries)
        return g

    @property
    def _margin(self) -> int:
        """Positions a verify pass writes past a request's budget."""
        return self.spec.gamma if self.spec is not None else 0

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.uid is None]

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.uid is not None]

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def admit(self, cache, tokens: torch.Tensor, uid: int,
              prompt: np.ndarray, max_new: int,
              session: Optional[str] = None):
        """Prefill ``prompt`` and place it in a free slot. Dense caches
        validate ``len(prompt) + max_new`` against ``ctx``; the paged path
        allocates on demand and raises ``PoolExhausted`` when the pool
        cannot hold the request now.

        ``session`` names a multi-turn conversation on a parking-enabled
        paged cache: at finish the slot's KV parks under this key instead
        of being dropped, and a later admit with the same key restores it
        and continues decoding — the prompt is ignored on restore (the
        parked state holds it) and the first decode step resumes from the
        parked resume token, so the concatenated streams are exactly what
        one uninterrupted request would have produced.
        """
        if session is not None and self.spec is not None:
            raise ValueError(
                "session parking and speculative decoding cannot be "
                "combined: the draft cache is not parked, so a restored "
                "slot would verify against a cold draft")
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots")
        slot = free[0]
        prompt = np.asarray(prompt)
        tr = self._tracker
        t_submit = self._submit_t.pop(uid, None)     # run(): its arrival
        if tr is not None:                           # no-op if already seen
            tr.submit(uid, t=t_submit, prompt_len=len(prompt))
        t_admit = clock() if tr is not None else 0.0
        if self.kv is not None and session is not None \
                and self.kv.is_parked(session):
            cache, meta, _ = self.kv.restore_session(cache, slot, session,
                                                     max_new=max_new)
            # the resume token's KV is written by the first decode step,
            # as the last generated token's would have been: remaining
            # counts the full max_new and generated starts empty (the
            # token was emitted last turn)
            tokens[slot, 0] = int(meta["resume_token"])
            self.slots[slot] = SlotState(
                uid=uid, remaining=max_new, generated=[], t_first=clock(),
                t_submit=self._t_start if t_submit is None else t_submit,
                session=session)
            if tr is not None:
                tr.admitted(uid, restored=True)
                tr.prefill_done(uid, clock() - t_admit)
            return cache, tokens
        prompt_t = torch.as_tensor(prompt, device=self.device)[None, :]
        if self.kv is not None and self.prefill_chunk is not None:
            self.kv.plan_admit(cache, slot, [int(t) for t in prompt],
                               max_new + self._margin, register=False)
            try:
                cache, tokens, first_tok = self._chunked_prefill(
                    cache, tokens, slot, prompt, uid)
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
        self.slots[slot] = SlotState(
            uid=uid, remaining=max_new - 1, generated=[int(first_tok)],
            t_first=clock(),
            t_submit=self._t_start if t_submit is None else t_submit,
            session=session)
        if tr is not None:
            tr.admitted(uid)
            tr.prefill_done(uid, clock() - t_admit)
            tr.token(uid)                # prefill emits the first token
        return cache, tokens

    def _chunked_prefill(self, cache, tokens, slot: int, prompt: np.ndarray,
                         uid: int):
        """Admit one prompt in page-aligned chunks computed straight into
        the slot's planned pages, one decode step for the active slots
        between chunks. Leading prefix-shared pages are skipped; a fully
        shared prompt re-derives its last logits read-only. Returns
        ``(cache, tokens, first_token)``. With a tracer or metrics
        attached each chunk ends in a device sync, so its span holds the
        chunk's device time (the JAX engine blocks on every chunk)."""
        kv = self.kv
        S = len(prompt)
        cache, skip = kv.begin_chunked_admit(cache, slot, S)
        table1 = torch.as_tensor(kv.chunk_table(slot), device=self.device)
        o, write = skip, True
        if skip >= S:
            o, write = S - 1, False
        logits = None
        n_chunks = 0
        timed = self.tracer.enabled or self._tracker is not None
        while o < S:
            c = min(self.prefill_chunk, S - o)
            view = {"pages": cache["pages"], "block_table": table1,
                    "len": torch.full((1,), o, dtype=torch.int32,
                                      device=self.device)}
            chunk = torch.as_tensor(prompt[o:o + c], device=self.device)
            t0 = clock()
            with self.tracer.span(f"prefill-chunk[{uid}:{n_chunks}]",
                                  cat="compute", track="decode", uid=uid):
                logits, _ = self.chunk_step(view, chunk[None, :], write)
                if timed:
                    self._sync_device()
            n_chunks += 1
            o += c
            if o < S and self.active():
                if self._tracker is not None:
                    self._tracker.interleave_stall(clock() - t0)
                cache, tokens = self.step(cache, tokens)
        first_tok = int(torch.argmax(logits[0, -1]))
        cache = kv.finish_chunked_admit(cache, slot, S)
        if self._tracker is not None:
            self._tracker.prefill_chunks(uid, n_chunks)
        return cache, tokens, first_tok

    def _finish(self, i: int, cache):
        st = self.slots[i]
        now = clock()
        n_later = len(st.generated) - 1
        self.finished.append(FinishedRequest(
            uid=st.uid, tokens=st.generated,
            ttft_s=st.t_first - st.t_submit,
            tpot_s=(now - st.t_first) / n_later if n_later else 0.0,
            proposed=st.proposed, accepted=st.accepted))
        if self._tracker is not None:
            self._tracker.finished(st.uid)
        self.slots[i] = SlotState()                      # free immediately
        if self.kv is not None:
            if st.session is not None and self.kv.parking and st.generated:
                try:
                    self.kv.park_session(
                        cache, i, st.session,
                        meta={"resume_token": int(st.generated[-1])})
                    return cache
                except BudgetExceeded:
                    # no tier can hold the parked bytes: finish normally;
                    # the next turn prefills from scratch instead of
                    # failing this one
                    self.tracer.instant(f"park-refused[{st.session}]",
                                        cat="sched", track="decode")
            self.kv.release_slot(i)
        return cache

    def step(self, cache, tokens: torch.Tensor):
        """One greedy decode step (or one draft/verify cycle) for every
        occupied slot: one token-step scope on the tracer, the decode
        call and its host sync charged to ``compute``."""
        t0 = clock() if self._tracker is not None else 0.0
        with self.tracer.token_step(self._step_idx, track="decode"):
            self._step_idx += 1
            if self.spec is not None:
                out = self._spec_step(cache, tokens)
            else:
                out = self._vanilla_step(cache, tokens)
        if self._tracker is not None:
            self._tracker.step_done(clock() - t0)
        return out

    def _vanilla_step(self, cache, tokens: torch.Tensor):
        if self.kv is not None:
            cache = self.kv.begin_step(cache, self.active(), 1)
        with self.tracer.phase("compute", track="decode"):
            logits, cache = self.decode(cache, tokens)
            nxt = torch.argmax(logits[:, 0], dim=-1)
            nxt_host = nxt.cpu().numpy()                 # the step's sync
        tokens = nxt[:, None].to(tokens.dtype)
        for i in self.active():
            st = self.slots[i]
            tok = int(nxt_host[i])
            if self.kv is not None:
                self.kv.advance(i)
            st.generated.append(tok)
            if self._tracker is not None:
                self._tracker.token(st.uid)
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
        with self.tracer.phase("compute", track="decode"):
            # the cycle's host sync is its n_emit read-back
            cache, res = self.spec.cycle(cache, tokens, active=self.active())
        tokens = res.next_tokens.to(tokens.dtype)
        accepted = proposed = 0
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
            proposed += self.spec.gamma
            accepted += n - 1
            for tok in res.emitted[i, :n]:
                tok = int(tok)
                st.generated.append(tok)
                if self._tracker is not None:
                    self._tracker.token(st.uid)
                st.remaining -= 1
                if st.remaining <= 0 or (self.eos_id is not None
                                         and tok == self.eos_id):
                    cache = self._finish(i, cache)
                    break
        if proposed:
            self._spec_proposed += proposed
            self._spec_accepted += accepted
            self.tracer.counter("spec/proposed", proposed, track="decode")
            self.tracer.counter("spec/accepted", accepted, track="decode")
        return cache, tokens

    def run(self, cache, requests, *, max_steps: int = 10_000,
            admit_patience: int = 256, respect_arrivals: bool = False):
        """Drive a request list to completion; returns (finished, steps).

        On the paged path a transiently exhausted pool defers the admit
        until finishes free pages; it propagates only when no active slot
        could ever free any. A request an *empty* pool could not hold, or
        whose admit was refused ``admit_patience`` consecutive steps, is
        shed onto ``self.rejected``.

        ``respect_arrivals=True`` replays each request's ``arrival_s``
        offset against the wall clock: a request is invisible to
        admission until its arrival passes, its metrics ``submit`` time
        (and its ``FinishedRequest.ttft_s``) counts from its arrival, and
        an idle engine sleeps until the next arrival instead of stepping.
        """
        from .kvcache import PoolExhausted

        tokens = torch.zeros((self.B, 1), dtype=torch.int32,
                             device=self.device)
        pending = list(requests)
        if respect_arrivals:
            pending.sort(key=lambda r: getattr(r, "arrival_s", 0.0))
        arrival = {r.uid: getattr(r, "arrival_s", 0.0) if respect_arrivals
                   else 0.0 for r in pending}
        deferrals: Dict[int, int] = {}
        steps = 0
        t_start = self._t_start = clock()

        def arrived(req):
            return arrival[req.uid] <= clock() - t_start

        while (pending or self.active()) and steps < max_steps:
            if self._tracker is not None:
                for req in pending:
                    if not arrived(req):
                        break
                    self._tracker.submit(
                        req.uid, t=t_start + arrival[req.uid],
                        prompt_len=len(req.prompt))
            while pending and self.free_slots() and arrived(pending[0]):
                req = pending.pop(0)
                try:
                    self._submit_t[req.uid] = t_start + arrival[req.uid]
                    with self.tracer.span(f"admit[{req.uid}]", cat="sched",
                                          track="decode", uid=req.uid):
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
                                   f"{req.uid}: {e}", "pool too small")
                        continue
                    n = deferrals.get(req.uid, 0) + 1
                    if n > admit_patience:
                        deferrals.pop(req.uid, None)
                        self._shed(req.uid, "deferred_ttl_expired",
                                   f"pool too small for request "
                                   f"{req.uid}: admission deferred "
                                   f"{n - 1} consecutive steps without "
                                   f"a slot freeing enough pages ({e})",
                                   "admit starved")
                        continue
                    deferrals[req.uid] = n
                    pending.insert(0, req)
                    break
            self._queued_n = len(pending)
            self._deferred_n = len(deferrals)
            if self.active():
                cache, tokens = self.step(cache, tokens)
            elif pending:
                # idle until the next arrival: a waiting engine burns
                # neither decode steps nor the step budget
                next_t = t_start + arrival[pending[0].uid]
                time.sleep(min(max(next_t - clock(), 0.0), 0.005))
                if self.kv is not None and self.kv.parking:
                    self.kv.sweep_parked()
                continue
            if self.kv is not None and self.kv.parking:
                self.kv.sweep_parked()
            if self.metrics is not None:
                self.metrics.sample()
            steps += 1
        self._queued_n = 0
        self._deferred_n = 0
        return self.finished, steps

    def _shed(self, uid: int, code: str, reason: str, why: str) -> None:
        self.rejected.append(RejectedRequest(uid=uid, reason=reason,
                                             code=code))
        self._submit_t.pop(uid, None)
        if self._tracker is not None:
            self._tracker.rejected(uid, code, reason)
        self.tracer.instant(f"reject[{uid}]", cat="sched", track="decode",
                            uid=uid, reason=why)


def write_dense_slot(cache, slot_cache, slot: int, length: int):
    """Copy a one-sequence dense cache (a prefill's) into ``slot`` of the
    batch cache, in place: every leaf of the tree is (layers, B, ...)."""
    for (_, dst), (_, src) in zip(_cache_leaves(cache),
                                  _cache_leaves(slot_cache)):
        dst[:, slot] = src[:, 0]
    cache["len"][slot] = slot_cache["len"][0]
    return cache


def make_dense_engine(params, cfg, batch: int, ctx: int, *,
                      eos_id: Optional[int] = None, spec=None,
                      cache_dtype=torch.float32, tracer=None, metrics=None,
                      graphs: bool = True,
                      device="cuda") -> ContinuousBatcher:
    """Reference dense-cache engine (prefill-one / slot-write / decode over
    ``models.decode_step``). Drive it with
    ``eng.run(init_cache(cfg, batch, ctx, dtype, device), reqs)``.
    ``spec``: a ``SpeculativeDecoder`` whose ``verify`` is the target's
    ``decode_step`` (``spec.verify = eng.decode`` replays it from the
    engine's graphs). ``graphs``: replay the decode step from CUDA graphs
    (``GraphedDecode``); ``False`` runs it eagerly, as a run with
    ``ops.use_kernels(False)`` on the card must."""
    from ..models import model as M

    def prefill_one(prompt):
        c1 = M.init_cache(cfg, 1, ctx, dtype=cache_dtype, device=device)
        logits, c1 = M.prefill(params, cfg, prompt, c1)
        return int(torch.argmax(logits[0, -1])), c1

    decode = dense_decode(params, cfg, graphs=graphs, device=device)
    return ContinuousBatcher(batch, prefill_one, write_dense_slot, decode,
                             eos_id=eos_id, spec=spec, ctx=ctx,
                             tracer=tracer, metrics=metrics, device=device,
                             graphs=decode.graphs if graphs else None)
