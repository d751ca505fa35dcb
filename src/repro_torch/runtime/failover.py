"""Elastic failover for the streamed ring (``runtime.elastic`` driven
from the serve path; ``repro.runtime.failover`` in PyTorch).

:class:`ElasticRingServer` closes the paper's A.5 loop for the streamed
ring:

  * **detect** — any exception out of a ring pass is walked for an
    :class:`iopolicy.StageFailure` (the classified form of "stage m is
    unreachable", injected by the fault schedule). Unattributed fatal
    errors rebuild the driver on the same stages (a wedged worker thread,
    not a dead stage).
  * **re-solve** — ``elastic.fail_stages`` drops the dead stage and
    recomputes the ring plan; the survivor set shrinks further until the
    ring fits the batch again (``batch % M == 0``). With device and model
    profiles attached, ``elastic.resolve_heterogeneous`` re-runs the full
    Halda solve over the survivors and its ``k`` is adopted where the
    uniform ring supports it.
  * **resume** — a fresh driver and ring cache are built for the new plan
    and the *entire* token history (prompt + every emitted token) is
    replayed through the ring (re-prefill: decode KV is the only
    non-checkpointed state). Emitted tokens are never discarded:
    generation resumes at the next token, and the replay is the same
    computation a clean run on the survivor ring performs, so the tokens
    after recovery equal that run's.

Every recovery emits a :class:`FailoverEvent` with the detect, re-solve,
rebuild and replay split and its tokens-lost accounting. The port's
stages share one device (``launch.mesh``), so the ring never runs out of
devices; it runs out of stages only when every stage has failed.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..launch.mesh import make_ring_layout
from ..quant.grouped import map_tree
from . import elastic
from . import serve as RS
from .iopolicy import IOPolicy, StageFailure, find_cause
from .streaming import StreamingRingDriver
from .telemetry import clock, resolve_tracer

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FailoverEvent:
    """One recovery: what died, what the new plan is, what it cost."""

    token_index: int              # emitted tokens when the failure struck
    failed_stage: Optional[int]   # original stage id (None = unattributed)
    generation: int               # elastic generation after recovery
    n_stages_before: int
    n_stages_after: int
    plan: Dict[str, int]          # new RingPlan as a dict
    halda: Optional[Dict[str, Any]]   # re-solve summary (profiles given)
    detect_s: float               # failure raised -> cause classified
    resolve_s: float              # elastic/Halda re-plan
    rebuild_s: float              # driver + cache rebuild
    replay_s: float               # re-prefill of the token history
    tokens_lost: int              # emitted tokens discarded (always 0)
    replayed_tokens: int

    @property
    def recovery_s(self) -> float:
        return self.detect_s + self.resolve_s + self.rebuild_s \
            + self.replay_s


class ElasticRingServer:
    """Streamed-ring generation loop with stage-failure recovery.

    ``store`` is any ``ParamStore``-like source (a ``faults.FaultyStore``
    in the fault runs); the head loads from it once and stays on
    ``device``, the blocks stream. The server owns the driver and cache
    construction so it can rebuild them when the stage set changes. The
    cache is f32 (``cache_dtype``) as in the JAX package.

    ``device_profiles``/``model_profile`` (``core.profiles``) are
    optional: when both are given, each failover re-runs the Halda solver
    over the surviving stages' profiles and adopts its ``k`` if the
    uniform-window ring supports it.
    """

    def __init__(self, cfg, store, *, batch: int, ctx: int, n_stages: int,
                 tp: int = 1, k: int = 1, prefetch_depth: int = 2,
                 max_failovers: int = 2, policy: Optional[IOPolicy] = None,
                 device_profiles: Optional[Sequence] = None,
                 model_profile=None, tracer=None, device="cuda",
                 cache_dtype=torch.float32):
        if not RS.ring_supported(cfg, batch, n_stages):
            raise ValueError(
                f"ring unsupported: family {cfg.family}, "
                f"batch {batch} % stages {n_stages} != 0")
        self.layout = make_ring_layout(n_stages, tp, device)
        self.cfg = cfg
        self.store = store
        self.batch = batch
        self.ctx = ctx
        self.tp = tp
        self.device = self.layout.device
        self.cache_dtype = cache_dtype
        self.prefetch_depth = prefetch_depth
        self.max_failovers = max_failovers
        self.policy = policy or IOPolicy()
        self.tracer = resolve_tracer(tracer)
        self.device_profiles = list(device_profiles) \
            if device_profiles is not None else None
        self.model_profile = model_profile
        self.state = elastic.initial_state(cfg, n_stages, k=k)
        self._head = None             # loaded at the first build
        self.events: List[FailoverEvent] = []
        self.driver: Optional[StreamingRingDriver] = None
        self._pending_event: Optional[Dict[str, Any]] = None

    # -- (re)construction -------------------------------------------------- #

    def _feasible(self, state: elastic.ElasticState
                  ) -> elastic.ElasticState:
        """Shrink the survivor set until the ring fits the batch
        (``batch % M == 0``). Dropping a healthy stage is graceful
        degradation, not data loss: its layers re-distribute like a
        failed stage's."""
        while True:
            M = len(state.stages)
            if M >= 1 and self.batch % M == 0:
                return state
            if M <= 1:
                raise RuntimeError(
                    f"no feasible ring: batch {self.batch}, {M} surviving "
                    f"stages")
            state = elastic.fail_stages(state, self.cfg,
                                        [state.stages[-1]])

    def _build(self):
        """A fresh ring-ordered cache and streaming driver for the current
        elastic state."""
        plan = self.state.plan
        self.layout = make_ring_layout(plan.n_stages, self.tp, self.device)
        if self._head is None:
            self._head = map_tree(lambda t: t.to(self.device),
                                  RS.pad_vocab(self.store.head(), self.cfg,
                                               self.tp))
        cache = RS.init_ring_cache(self.cfg, plan, self.batch, self.ctx,
                                   dtype=self.cache_dtype,
                                   device=self.device)
        self.driver = StreamingRingDriver(
            self.cfg, plan, self.store, prefetch_depth=self.prefetch_depth,
            device=self.device, policy=self.policy, tracer=self.tracer,
            head=self._head)
        return self.driver, cache

    # -- recovery ---------------------------------------------------------- #

    def _resolve(self, exc: BaseException, n_emitted: int,
                 t_detect0: float) -> None:
        """Classify ``exc``, update the elastic state, record the event's
        first half (completed by ``generate`` after rebuild and replay)."""
        cause = find_cause(exc, StageFailure)
        detect_s = clock() - t_detect0
        before = len(self.state.stages)
        t0 = clock()
        failed_id: Optional[int] = None
        halda_info: Optional[Dict[str, Any]] = None
        if cause is not None and 0 <= cause.stage < before:
            failed_id = self.state.stages[cause.stage]
            self.state = elastic.fail_stages(self.state, self.cfg,
                                             [failed_id])
            self.state = self._feasible(self.state)
            if self.device_profiles is not None \
                    and self.model_profile is not None:
                profs = [self.device_profiles[s] for s in
                         self.state.stages
                         if s < len(self.device_profiles)]
                try:
                    sol = elastic.resolve_heterogeneous(
                        profs, self.model_profile)
                    halda_info = {"k": int(sol.k),
                                  "w": [int(x) for x in sol.w],
                                  "latency_s": float(sol.latency)}
                    per = self.state.plan.L_pad \
                        // self.state.plan.n_stages
                    if sol.k >= 1 and per % sol.k == 0 \
                            and sol.k != self.state.plan.k:
                        self.state = elastic.fail_stages(
                            self.state, self.cfg, [], k=int(sol.k))
                except Exception as e:      # re-solve is best-effort
                    log.warning("halda re-solve failed: %s", e)
        else:
            # unattributed: rebuild on the same stages (a wedged worker,
            # not a dead stage)
            log.warning("unattributed ring failure at token %d: %s",
                        n_emitted, exc)
        resolve_s = clock() - t0
        self._pending_event = dict(
            token_index=n_emitted, failed_stage=failed_id,
            generation=self.state.generation,
            n_stages_before=before,
            n_stages_after=len(self.state.stages),
            plan=dataclasses.asdict(self.state.plan),
            halda=halda_info, detect_s=detect_s, resolve_s=resolve_s)

    def _column(self, col: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(col, np.int32),
                            device=self.device).reshape(self.batch, 1)

    def _next(self, logits: torch.Tensor) -> np.ndarray:
        return logits[:, 0, :self.cfg.vocab].argmax(-1).to(
            torch.int32).cpu().numpy()

    def _replay(self, driver, cache, history: List[np.ndarray]):
        """Feed every history column through the ring (re-prefill);
        returns (cache, the next token column)."""
        logits = None
        for col in history:
            tok = self._column(col)
            logits, cache = driver.step(cache, tok)
        return cache, self._next(logits)

    # -- generation -------------------------------------------------------- #

    def generate(self, prompts, max_new: int) -> np.ndarray:
        """Greedy-decode ``max_new`` tokens per sequence; returns
        ``(batch, max_new)`` int32. Failures mid-stream recover per the
        module docstring; ``self.events`` records each one."""
        prompts = np.asarray(prompts, np.int32)
        if prompts.shape[0] != self.batch:
            raise ValueError(f"prompts batch {prompts.shape[0]} != "
                             f"engine batch {self.batch}")
        history: List[np.ndarray] = [prompts[:, t]
                                     for t in range(prompts.shape[1])]
        emitted: List[np.ndarray] = []
        driver = None
        failovers = 0
        while len(emitted) < max_new:
            try:
                if driver is None:
                    t_b0 = clock()
                    driver, cache = self._build()
                    rebuild_s = clock() - t_b0
                    t_r0 = clock()
                    cache, nxt = self._replay(driver, cache, history)
                    replay_s = clock() - t_r0
                    ev = self._pending_event
                    if ev is not None:
                        fe = FailoverEvent(
                            **ev, rebuild_s=rebuild_s, replay_s=replay_s,
                            tokens_lost=0, replayed_tokens=len(history))
                        self.events.append(fe)
                        # recovery splits land on the shared timeline as
                        # back-to-back spans ending now
                        self.tracer.ingest_failover_event(fe,
                                                          t_end=clock())
                        self._pending_event = None
                while len(emitted) < max_new:
                    emitted.append(nxt)
                    history.append(nxt)
                    if len(emitted) >= max_new:
                        break
                    tok = self._column(nxt)
                    logits, cache = driver.step(cache, tok)
                    nxt = self._next(logits)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as exc:
                t_caught = clock()
                self.tracer.instant("stage_failure", cat="failover",
                                    track="failover",
                                    token_index=len(emitted),
                                    error=type(exc).__name__)
                failovers += 1
                if failovers > self.max_failovers:
                    raise
                log.warning("ring failure at token %d (failover %d/%d): "
                            "%s", len(emitted), failovers,
                            self.max_failovers, exc)
                if driver is not None:
                    driver.close()
                    driver = None
                    self.driver = None
                self._resolve(exc, len(emitted), t_caught)
        return np.stack(emitted, axis=1) if emitted \
            else np.zeros((self.batch, 0), np.int32)

    def stats(self):
        return self.driver.stats() if self.driver is not None else None

    def close(self) -> None:
        if self.driver is not None:
            self.driver.close()
            self.driver = None
