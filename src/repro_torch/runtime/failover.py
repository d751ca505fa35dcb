"""Elastic failover for the streamed ring (``runtime.elastic`` driven
from the serve path; ``repro.runtime.failover`` in PyTorch).

:class:`ElasticRingServer` closes the paper's A.5 loop for the streamed
ring, in one process (every stage on one device, tp 1) or across rank
processes (``ranks``, the default at tp > 1: a ``launch.mesh.RankWorld``
of M x tp ranks, one a (stage, member), each streaming only its stage's
windows and its part of each leaf, ``serve.rank_stream_job``'s path, as
the JAX server runs its ring over an (M, tp) device mesh):

  * **detect** — a rank process that died (one the parent killed, at
    once, else its exit code or signal, which the parent waits for while
    a survivor's error says a peer went away; it then ends the world at
    once: survivors blocked in a collective with the dead peer never wait
    out their timeout) or a rank whose read raised an
    :class:`iopolicy.StageFailure` is
    attributed to that rank's stage; in one process any exception out of
    a ring pass is walked for a ``StageFailure`` (the classified form of
    "stage m is unreachable", injected by the fault schedule).
    Unattributed fatal errors rebuild the ring on the same stages (a
    wedged worker thread, not a dead stage).
  * **re-solve** — ``elastic.fail_stages`` drops the dead stage and
    recomputes the ring plan; the survivor set shrinks further until the
    ring fits the batch again (``batch % M == 0``). With device and model
    profiles attached, ``elastic.resolve_heterogeneous`` re-runs the full
    Halda solve over the survivors and its ``k`` is adopted where the
    uniform ring supports it. The tp stays.
  * **resume** — a fresh ring is built for the new plan (across ranks: a
    world of M' x tp new processes, each loading its head shard and
    opening its windows) and the *entire* token history (prompt + every
    emitted token) is replayed through it (re-prefill: decode KV is the
    only non-checkpointed state). Emitted tokens are never discarded:
    the parent holds them (across ranks it drives the generation a token
    a job), generation resumes at the next token, and the replay is the
    same computation a clean run on the survivor ring performs, so the
    tokens after recovery equal that run's.

Every recovery emits a :class:`FailoverEvent` with the detect, re-solve,
rebuild and replay split and its tokens-lost accounting. The detect,
re-solve and replay logic is one code path for both layouts; only the
ring under it differs (``_OneProcessRing``, ``_RankRing``).
:class:`RankChaos` makes a rank die on purpose: the parent ``SIGKILL``s
it as the pass of a given token starts, or its first layer read of that
pass raises.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..launch.mesh import RankFailure, RankWorld, make_ring_layout
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


@dataclasses.dataclass(frozen=True)
class RankChaos:
    """A rank of the first ring across ranks dies at the pass of token
    ``token`` (the pass that computes it): stage ``stage``'s first rank
    (member 0). ``mode`` "kill": the parent sends it ``SIGKILL`` as the
    pass starts; "stage_failure": its first layer read of the pass raises
    ``StageFailure``; "error": that read raises ``ValueError`` (fatal,
    and not a stage's death). Worlds rebuilt after a failure run clean."""

    stage: int = 1
    token: int = 2
    mode: str = "kill"

    def __post_init__(self):
        if self.mode not in ("kill", "stage_failure", "error"):
            raise ValueError(f"unknown chaos mode {self.mode!r}")


# --------------------------------------------------------------------------- #
#  the ring under the server: in one process, or across ranks
# --------------------------------------------------------------------------- #

class _OneProcessRing:
    """Every stage in this process on one device: a
    ``StreamingRingDriver`` over the server's store and its ring cache."""

    def __init__(self, srv: "ElasticRingServer", history: int):
        plan = srv.state.plan
        srv.layout = make_ring_layout(plan.n_stages, srv.tp, srv.device)
        if srv._head is None:
            srv._head = map_tree(lambda t: t.to(srv.device),
                                 RS.pad_vocab(srv.store.head(), srv.cfg,
                                              srv.tp))
        self.srv = srv
        self.cache = RS.init_ring_cache(srv.cfg, plan, srv.batch, srv.ctx,
                                        dtype=srv.cache_dtype,
                                        device=srv.device)
        self.driver = StreamingRingDriver(
            srv.cfg, plan, srv.store, prefetch_depth=srv.prefetch_depth,
            device=srv.device, policy=srv.policy, tracer=srv.tracer,
            head=srv._head)

    def run(self, columns: Sequence[np.ndarray], token: int) -> np.ndarray:
        """One pass a column; the greedy tokens (B,) after the last."""
        srv = self.srv
        for col in columns:
            tok = torch.tensor(np.asarray(col, np.int32),
                               device=srv.device).reshape(srv.batch, 1)
            logits, self.cache = self.driver.step(self.cache, tok)
        return logits[:, 0, :srv.cfg.vocab].argmax(-1).to(
            torch.int32).cpu().numpy()

    def stats(self):
        return self.driver.stats()

    def close(self) -> None:
        self.driver.close()


OPEN_JOB = "repro_torch.runtime.failover:rank_serve_open"
STEPS_JOB = "repro_torch.runtime.failover:rank_serve_steps"


class _RankRing:
    """The ring across M x tp rank processes (a ``RankWorld``), each
    streaming its part (``rank_serve_open``), driven a job at a time
    (``rank_serve_steps``): the parent holds every token."""

    def __init__(self, srv: "ElasticRingServer", history: int):
        from ..kernels import _build

        plan = srv.state.plan
        self.srv = srv
        chaos = srv.chaos if srv.builds == 0 else None
        self.kill = None
        fault = None
        if chaos is not None:
            rank = chaos.stage * srv.tp
            if chaos.mode == "kill":
                self.kill = (chaos.token, rank)
            else:
                from .faults import FaultSpec

                rows = RS._rank_rows(plan, chaos.stage)
                per_pass = int((rows < srv.cfg.n_layers).sum())
                # passes before token t's: the history's, then t - 1
                after = per_pass * (history + chaos.token - 1)
                fault = (rank, FaultSpec(
                    op="layer_read", mode=chaos.mode, stage=chaos.stage,
                    after=after, times=1, error_type=ValueError))
        if srv.device.type == "cuda":
            _build.build()         # before the ranks: they never race it
        size = plan.n_stages * srv.tp
        given = srv.world if srv.builds == 0 else None
        self.owned = given is None or given.world != size
        # one torch thread a rank, as the driver's ranks: the card does
        # the work, and thread pools would spin against each other
        self.world = RankWorld(size, device=str(srv.device),
                               threads=1) if self.owned else given
        self.world.run(
            OPEN_JOB, cfg=srv.cfg, n_stages=plan.n_stages, tp=srv.tp,
            k=plan.k, store=srv.store, batch=srv.batch, max_len=srv.ctx,
            cache_dtype=srv.cache_dtype, depth=srv.prefetch_depth,
            policy=srv.policy, fault=fault)

    def run(self, columns: Sequence[np.ndarray], token: int) -> np.ndarray:
        jid = self.world.submit(STEPS_JOB, columns=np.stack(columns))
        if self.kill is not None and self.kill[0] == token:
            self.world.kill(self.kill[1])
            self.kill = None
        outs = self.world.collect(jid, STEPS_JOB)
        if any(not np.array_equal(o, outs[0]) for o in outs):
            raise RuntimeError("the ranks took different greedy tokens")
        return outs[0]

    def stats(self):
        return None

    def close(self) -> None:
        if self.owned:
            self.world.close()


def rank_serve_open(ctx, *, cfg, n_stages: int, tp: int, k: int, store: str,
                    batch: int, max_len: int, cache_dtype, depth: int,
                    policy=None, fault=None) -> Dict[str, Any]:
    """A rank's ring for ``ElasticRingServer`` (a ``RankWorld`` job): its
    head shard, its streamed windows over the store at ``store``
    (``serve._rank_windows``; ``fault`` as there), its part of an empty
    ring cache and its ``RankRingStep``, kept in ``ctx.state`` for
    ``rank_serve_steps``. Returns the rank's coordinates and seconds to
    load."""
    from .paramstore import ParamStore

    t0 = clock()
    old = ctx.state.pop("ring", None)
    if old is not None:
        old["windows"].close()
        old["src"].close()
    lay = ctx.layout(n_stages, tp)
    plan = RS.RingPlan.make(cfg, n_stages, k)
    src = ParamStore(store)
    windows, head = RS._rank_windows(src, cfg, plan, lay, depth=depth,
                                     policy=policy, fault=fault)
    ctx.state["ring"] = dict(
        cfg=cfg, layout=lay, src=src, windows=windows,
        step=RS.RankRingStep(cfg, plan, lay, head, windows=windows),
        cache=RS.rank_init_cache(cfg, plan, lay, batch, max_len,
                                 dtype=cache_dtype))
    RS._sync(lay.device)
    return {"rank": ctx.rank, "stage": lay.stage, "member": lay.member,
            "load_s": clock() - t0}


def rank_serve_steps(ctx, *, columns: np.ndarray) -> np.ndarray:
    """One ring pass a column of ``columns`` (n, B) on the rank's ring
    (``rank_serve_open``); the greedy tokens (B,) after the last, equal
    on every rank."""
    st = ctx.state["ring"]
    lay = st["layout"]
    logits = None
    for col in columns:
        tok = torch.as_tensor(np.asarray(col, np.int32),
                              device=lay.device).reshape(-1, 1)
        logits, st["cache"] = st["step"](st["cache"], tok)
    nxt = RS.rank_greedy(logits, lay.model, st["cfg"].vocab)
    return nxt[:, 0].cpu().numpy()


class ElasticRingServer:
    """Streamed-ring generation loop with stage-failure recovery.

    In one process (``ranks`` False, the default at tp 1), ``store`` is
    any ``ParamStore``-like source (a ``faults.FaultyStore`` in the fault
    runs); the head loads from it once and stays on ``device``, the
    blocks stream. Across ranks (``ranks``, the default at tp > 1),
    ``store`` is a layer store's directory, which every rank opens
    itself; each generation of the ring is a ``RankWorld`` of M x tp
    ranks on ``device`` (one torch thread each) and ``chaos``
    (a :class:`RankChaos`) can kill a rank of the first. The server owns
    the ring's construction so it can rebuild it when the stage set
    changes. The cache is f32 (``cache_dtype``) as in the JAX package.
    ``world``: a ``RankWorld`` of M x tp ranks to run the first ring on
    (a world that served an earlier job; the server leaves it running
    unless a failure ended it); ``take_world`` hands the last ring's
    world on (to a reference run on the same survivors).

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
                 cache_dtype=torch.float32, ranks: Optional[bool] = None,
                 chaos: Optional[RankChaos] = None,
                 world: Optional[RankWorld] = None):
        if not RS.ring_supported(cfg, batch, n_stages):
            raise ValueError(
                f"ring unsupported: family {cfg.family}, "
                f"batch {batch} % stages {n_stages} != 0")
        self.ranks = tp > 1 if ranks is None else ranks
        if self.ranks:
            if not isinstance(store, str):
                raise TypeError("across ranks the store is a layer store's "
                                "directory: every rank opens it itself")
            self.layout = None
        else:
            if chaos is not None:
                raise ValueError("RankChaos kills a rank: it needs the ring "
                                 "across ranks (ranks=True)")
            self.layout = make_ring_layout(n_stages, tp, device)
        self.cfg = cfg
        self.store = store
        self.batch = batch
        self.ctx = ctx
        self.tp = tp
        self.device = torch.device(device)
        self.cache_dtype = cache_dtype
        self.prefetch_depth = prefetch_depth
        self.max_failovers = max_failovers
        self.policy = policy or IOPolicy()
        self.tracer = resolve_tracer(tracer)
        self.device_profiles = list(device_profiles) \
            if device_profiles is not None else None
        self.model_profile = model_profile
        self.chaos = chaos
        self.world = world
        self.state = elastic.initial_state(cfg, n_stages, k=k)
        self._head = None             # loaded at the first build
        self.events: List[FailoverEvent] = []
        self.failures: List[BaseException] = []   # what each event caught
        self.ring = None
        self.builds = 0               # rings built (chaos hits the first)
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

    def _build(self, history: int):
        """A fresh ring for the current elastic state: in this process or
        across ranks. ``history``: the tokens it will replay."""
        ring = _RankRing if self.ranks else _OneProcessRing
        self.ring = ring(self, history)
        self.builds += 1
        return self.ring

    # -- recovery ---------------------------------------------------------- #

    def _failed_stage(self, exc: BaseException) -> Optional[int]:
        """The current plan's stage that ``exc`` attributes the failure
        to: a dead rank's, else a rank's whose read raised
        ``StageFailure``; in one process the ``StageFailure``'s own. None:
        unattributed."""
        if isinstance(exc, RankFailure):
            M = self.state.plan.n_stages
            died = exc.ranks("died")
            lost = [e.rank for e in exc.errors
                    if e.kind == "raised" and e.stage_failure]
            for r in died + lost:
                return (r // self.tp) % M
            return None
        cause = find_cause(exc, StageFailure)
        return cause.stage if cause is not None else None

    def _resolve(self, exc: BaseException, n_emitted: int,
                 t_detect0: float) -> None:
        """Classify ``exc``, update the elastic state, record the event's
        first half (completed by ``generate`` after rebuild and replay)."""
        stage = self._failed_stage(exc)
        detect_s = clock() - t_detect0
        before = len(self.state.stages)
        t0 = clock()
        failed_id: Optional[int] = None
        halda_info: Optional[Dict[str, Any]] = None
        if stage is not None and 0 <= stage < before:
            failed_id = self.state.stages[stage]
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
        ring = None
        failovers = 0
        while len(emitted) < max_new:
            try:
                if ring is None:
                    t_b0 = clock()
                    ring = self._build(len(history))
                    rebuild_s = clock() - t_b0
                    t_r0 = clock()
                    nxt = ring.run(history, len(emitted))
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
                    nxt = ring.run([nxt], len(emitted))
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as exc:
                t_caught = clock()
                self.failures.append(exc)
                self.tracer.instant("stage_failure", cat="failover",
                                    track="failover",
                                    token_index=len(emitted),
                                    error=type(exc).__name__)
                failovers += 1
                if ring is not None:
                    ring.close()
                    ring = self.ring = None
                if failovers > self.max_failovers:
                    raise
                log.warning("ring failure at token %d (failover %d/%d): "
                            "%s", len(emitted), failovers,
                            self.max_failovers,
                            str(exc).splitlines()[0] if str(exc) else
                            type(exc).__name__)
                self._resolve(exc, len(emitted),
                              getattr(exc, "t_first", t_caught))
        return np.stack(emitted, axis=1) if emitted \
            else np.zeros((self.batch, 0), np.int32)

    def stats(self):
        return self.ring.stats() if self.ring is not None else None

    def take_world(self) -> Optional[RankWorld]:
        """The last ring's ``RankWorld``, left running for the caller,
        who closes it (None in one process)."""
        ring = self.ring
        if not isinstance(ring, _RankRing):
            return None
        ring.owned = False
        return ring.world

    def close(self) -> None:
        if self.ring is not None:
            self.ring.close()
            self.ring = None
