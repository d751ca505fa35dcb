"""The port's ring layouts: M pipeline stages of the piped ring on one
device, or one rank a (pod, stage, member) across processes.

The JAX package lays the ring over a ("pod", "data", "model") device
mesh: one stage per "data" coordinate, a tensor-parallel group of "model"
chips inside it, each pod a replica over its part of the batch.

``make_ring_layout`` is the one-process ring: every stage in one process
on one card (each stage with its own rows of the layer bank and its own
slice of the cache, the ring hop a hand-off between stages), so its
layout is the stage count, tp = 1 and the device.

``make_production_mesh`` and ``make_debug_mesh`` are the JAX package's
meshes as the port's ordered ``{axis: size}`` dicts (16 x 16, or 2 x 16
x 16 with pods; (n_stages, tp) for tests and the serve CLI): the specs of
``runtime.sharding`` and the dry run read them.

``make_rank_layout`` is the ring across ranks: ``pods x n_stages x tp``
processes, rank ``r`` at pod ``r // (n_stages tp)``, stage ``(r // tp) %
n_stages``, member ``r % tp``, joined by ``torch.distributed`` over gloo
(``init_rank_world``: the rendezvous is a ``FileStore`` in a temporary
directory, never a TCP port, so parallel runs cannot clash). Each rank
holds two groups, both with a timeout, so a dead or stuck rank fails the
run instead of hanging it: the "model" group of its stage (the merges of
the sequence-split attention, the sums after the split FFN and the
vocab-sharded embed, the greedy argmax over the vocab shards) and the
ring of its member (the ring hop, the final hiddens' sum over the
stages). Nothing runs on the global default group. The GSPMD layer
(``runtime.gspmd``) runs on the same world: its "data" axis (FSDP, the
batch) is the ring of a member, its "model" axis the stage's group, and
a third group, ``pod``, joins the ranks of one stage and member across
the pods (the batch's other axis, over which gradients also sum).
``dry_rank_layout`` is one rank's layout with no process groups: the dry
run's (``runtime.collectives.dry_axis``).

``RankWorld`` starts the ranks (``torch.multiprocessing``, start method
``forkserver``: the server imports torch and the ring's modules once and
each rank forks from it, where a spawned rank spent seconds of CPU
importing them again) and runs jobs on all of them: ``"module:function"`` called as
``function(ctx, **kwargs)`` on each rank with a ``RankContext``, whose
``state`` dict lives as long as the rank, so a later job can go on where
an earlier one stopped (the failover drives a generation a token a job).
A rank that dies (its exit code or signal), raises (its traceback, and
whether an ``iopolicy.StageFailure`` was among the causes) or does not
answer in time makes the job raise ``RankFailure`` with a ``RankError``
for each, and the parent kills the whole world at once: survivors blocked
in a collective with a dead peer never wait out their timeout.
``RankWorld.kill`` sends a rank ``SIGKILL`` (a dead device, for the tests
and the chaos runs); a rank the parent killed counts as dead at once.
Gloo tells the survivors of a dead peer before the parent can see its
exit, so while a survivor's error says its peer went away the parent
waits up to ``PEER_GRACE_S`` for that exit: the death, not the
survivors' errors, is what the failure names.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import queue
import re
import shutil
import signal
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..runtime.collectives import Axis, dry_axis
from ..runtime.telemetry import clock

#: seconds a collective waits for its peers before the rank fails
RANK_TIMEOUT_S = 300.0
#: a rank hands its CUDA cache back to the card (which the ranks share)
#: after a job that left more than this unused in it
EMPTY_CACHE_BYTES = 1 << 30
#: what the fork server imports before it forks a rank (none of them
#: touches CUDA at import, so each rank starts its own CUDA context)
PRELOAD = ("torch", "numpy", "repro_torch.launch.mesh",
           "repro_torch.runtime.serve", "repro_torch.runtime.failover",
           "repro_torch.runtime.gspmd", "repro_torch.runtime.train")


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """16 x 16 = 256 chips a pod; the multi-pod mesh adds a leading
    2-pod data-parallel axis (512 chips)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_debug_mesh(n_stages: int = 4, tp: int = 2, *,
                    multi_pod: bool = False) -> Dict[str, int]:
    """A small mesh: (n_stages, tp), with 2 pods in front for
    ``multi_pod``."""
    mesh = {"pod": 2} if multi_pod else {}
    mesh.update(data=n_stages, model=tp)
    return mesh


@dataclasses.dataclass(frozen=True)
class RingLayout:
    n_stages: int
    tp: int
    device: torch.device


def make_ring_layout(n_stages: int = 4, tp: int = 1,
                     device="cuda") -> RingLayout:
    """The layout of an ``n_stages`` ring on ``device``, in one process.
    ``tp`` must be 1: a tensor-parallel group inside a stage needs one
    rank per member (``make_rank_layout``)."""
    if tp != 1:
        raise ValueError(f"tp={tp}: the one-process ring runs each stage on "
                         f"one device (tp=1); a tensor-parallel group runs "
                         f"across ranks, a process each (make_rank_layout "
                         f"in a RankWorld: runtime.serve.rank_ring_job and "
                         f"rank_stream_job, ElasticRingServer(ranks=True))")
    if n_stages < 1:
        raise ValueError(f"n_stages={n_stages}: a ring needs a stage")
    return RingLayout(n_stages=n_stages, tp=1, device=torch.device(device))


# --------------------------------------------------------------------------- #
#  the ring across ranks
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class RankLayout:
    """One rank of a ``pods x n_stages x tp`` ring: its coordinates, its
    device and its groups (``model``: its stage's members, in member
    order; ``ring``: its member's stages in its pod, in stage order;
    ``pods_axis``: its stage's member across the pods, in pod order, an
    axis of one member in a one-pod world)."""
    pods: int
    n_stages: int
    tp: int
    rank: int
    pod: int
    stage: int
    member: int
    device: torch.device
    model: Axis
    ring: Axis
    pods_axis: Axis

    @property
    def world(self) -> int:
        return self.pods * self.n_stages * self.tp

    @property
    def mesh(self) -> Dict[str, int]:
        """The JAX mesh this layout stands for: ("pod",) "data", "model"."""
        m = {"pod": self.pods} if self.pods > 1 else {}
        m.update(data=self.n_stages, model=self.tp)
        return m

    @property
    def coords(self) -> Dict[str, int]:
        return {"pod": self.pod, "data": self.stage, "model": self.member}

    def set_tracer(self, tracer) -> None:
        """Record this rank's collectives on ``tracer``'s ``comm`` track."""
        for ax in (self.model, self.ring, self.pods_axis):
            ax.tracer = tracer


def rank_coords(rank: int, n_stages: int, tp: int):
    """(pod, stage, member) of ``rank``."""
    return rank // (n_stages * tp), (rank // tp) % n_stages, rank % tp


def init_rank_world(rank: int, world: int, store_path: str, *,
                    timeout_s: float = RANK_TIMEOUT_S) -> None:
    """Join the gloo world of ``world`` ranks through the ``FileStore`` at
    ``store_path``."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


_GROUPS: Dict[tuple, Any] = {}


def _group(ranks: Sequence[int], timeout_s: float):
    """The process group of ``ranks`` (every rank of the world creates
    every group, in one order), made once a process."""
    import torch.distributed as dist

    key = tuple(ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(
            list(ranks), timeout=datetime.timedelta(seconds=timeout_s))
    return _GROUPS[key]


def make_rank_layout(n_stages: int, tp: int, pods: int = 1, *, rank: int,
                     device="cuda", timeout_s: float = RANK_TIMEOUT_S
                     ) -> RankLayout:
    """Rank ``rank``'s place in a ``pods x n_stages x tp`` ring, in a
    world ``init_rank_world`` joined (every rank calls this with the same
    shape: the groups are made collectively)."""
    import torch.distributed as dist

    if min(n_stages, tp, pods) < 1:
        raise ValueError(f"a rank ring needs pods, n_stages and tp >= 1 "
                         f"(got {pods}, {n_stages}, {tp})")
    world = pods * n_stages * tp
    if dist.get_world_size() != world:
        raise ValueError(f"{pods} x {n_stages} x {tp} ranks in a world of "
                         f"{dist.get_world_size()}")
    model_ranks = [[p * n_stages * tp + m * tp + i for i in range(tp)]
                   for p in range(pods) for m in range(n_stages)]
    ring_ranks = [[p * n_stages * tp + m * tp + i for m in range(n_stages)]
                  for p in range(pods) for i in range(tp)]
    pod_ranks = [[p * n_stages * tp + m * tp + i for p in range(pods)]
                 for m in range(n_stages) for i in range(tp)] \
        if pods > 1 else []
    groups = {tuple(r): _group(r, timeout_s)
              for r in model_ranks + ring_ranks + pod_ranks}
    pod, stage, member = rank_coords(rank, n_stages, tp)
    mine = model_ranks[pod * n_stages + stage]
    ring = ring_ranks[pod * tp + member]
    across = Axis("pod", None, (rank,), 0)
    if pods > 1:
        r = pod_ranks[stage * tp + member]
        across = Axis("pod", groups[tuple(r)], tuple(r), pod)
    return RankLayout(
        pods=pods, n_stages=n_stages, tp=tp, rank=rank, pod=pod,
        stage=stage, member=member, device=torch.device(device),
        model=Axis("model", groups[tuple(mine)], tuple(mine), member),
        ring=Axis("data", groups[tuple(ring)], tuple(ring), stage),
        pods_axis=across)


def dry_rank_layout(mesh: Dict[str, int], rank: int = 0,
                    device="meta") -> RankLayout:
    """Rank ``rank``'s place in ``mesh`` with dry axes: no world, no
    process group (``runtime.collectives.dry_axis``)."""
    pods, n_stages, tp = mesh.get("pod", 1), mesh["data"], mesh["model"]
    pod, stage, member = rank_coords(rank, n_stages, tp)
    return RankLayout(
        pods=pods, n_stages=n_stages, tp=tp, rank=rank, pod=pod,
        stage=stage, member=member, device=torch.device(device),
        model=dry_axis("model", tp, member),
        ring=dry_axis("data", n_stages, stage),
        pods_axis=dry_axis("pod", pods, pod))


@dataclasses.dataclass
class RankContext:
    """What a job gets on its rank: the rank, the world's size, the
    rank's device, the collectives' timeout and ``state``, kept between
    the jobs of one rank process."""
    rank: int
    world: int
    device: str
    timeout_s: float
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def layout(self, n_stages: int, tp: int, pods: int = 1) -> RankLayout:
        return make_rank_layout(n_stages, tp, pods, rank=self.rank,
                                device=self.device,
                                timeout_s=self.timeout_s)


def _resolve(fn: str):
    module, name = fn.split(":")
    return getattr(importlib.import_module(module), name)


def _raised(e: BaseException) -> Dict[str, Any]:
    """What the parent learns of an exception on a rank: its traceback
    and whether a ``StageFailure`` is among its causes."""
    from ..runtime.iopolicy import StageFailure, find_cause

    return {"traceback": traceback.format_exc(),
            "stage_failure": find_cause(e, StageFailure) is not None}


def _rank_main(rank: int, world: int, store_path: str, device: str,
               threads: Optional[int], timeout_s: float, jobs, results
               ) -> None:
    """A rank process: join the world, then run jobs until ``None``."""
    if threads:
        torch.set_num_threads(threads)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        init_rank_world(rank, world, store_path, timeout_s=timeout_s)
    except BaseException as e:                  # noqa: BLE001
        results.put((None, rank, False, _raised(e)))
        return
    ctx = RankContext(rank, world, device, timeout_s)
    while True:
        job = jobs.get()
        if job is None:
            break
        jid, fn, kwargs = job
        del job
        try:
            out, ok = _resolve(fn)(ctx, **kwargs), True
        except BaseException as e:              # noqa: BLE001
            out, ok = _raised(e), False
        # the job's arguments go before its result does (CUDA tensors the
        # parent handed over stay allocated in the parent while a rank
        # holds them), and a large job's freed memory goes back to the
        # card
        del kwargs
        if dev.type == "cuda" and torch.cuda.memory_reserved(dev) \
                - torch.cuda.memory_allocated(dev) > EMPTY_CACHE_BYTES:
            torch.cuda.empty_cache()
        results.put((jid, rank, ok, out))
        out = None
    import torch.distributed as dist

    dist.destroy_process_group()


#: what gloo raises on a rank whose peer in a collective went away
_PEER_LOST = re.compile(r"Connection (closed|reset) by peer|Broken pipe")


@dataclasses.dataclass(frozen=True)
class RankError:
    """One rank's part in a failed job: ``kind`` "died" (``exitcode``, and
    ``signal`` where a signal ended it), "raised" (``traceback``;
    ``stage_failure``: a ``StageFailure`` was among its causes) or
    "silent" (no answer before the deadline)."""
    rank: int
    kind: str
    exitcode: Optional[int] = None
    signal: Optional[int] = None
    traceback: str = ""
    stage_failure: bool = False

    def describe(self) -> str:
        if self.kind == "died":
            how = f"killed by signal {self.signal}" if self.signal \
                else f"exited with code {self.exitcode}"
            return f"rank {self.rank} {how}"
        if self.kind == "raised":
            last = self.traceback.strip().splitlines()[-1:] or [""]
            return f"rank {self.rank} raised: {last[0]}"
        return f"rank {self.rank} did not answer in time"


class RankFailure(RuntimeError):
    """A rank raised, died or did not answer in time: ``errors`` says
    which and how; on ``telemetry.clock``, ``t_seen`` is when the parent
    saw it (before it ended the world) and ``t_first`` the earliest
    moment it knows of (when it killed the rank itself, else
    ``t_seen``)."""

    def __init__(self, msg: str, errors: Sequence[RankError] = (),
                 t_first: Optional[float] = None):
        super().__init__(msg)
        self.errors = list(errors)
        self.t_seen = clock()
        self.t_first = self.t_seen if t_first is None else t_first

    def ranks(self, kind: str) -> List[int]:
        return [e.rank for e in self.errors if e.kind == kind]


class RankWorld:
    """``world`` rank processes (start method ``forkserver``) joined over
    gloo, running jobs: ``run("module:function", **kwargs)`` calls
    ``function(ctx, **kwargs)`` on every rank and returns the results in
    rank order (``submit`` then ``collect``, for a caller that acts
    between the two). A rank that raises, dies or outlasts ``timeout_s``
    makes the job raise ``RankFailure`` and ends the world at once (the
    next job starts a new one). Every rank runs on ``device``;
    ``threads``: torch threads a rank."""

    #: seconds the parent waits, after a rank raised, for the other
    #: ranks' errors before it ends the world
    GRACE_S = 0.25
    #: seconds it waits for a rank's exit while a survivor's error says
    #: a peer went away (gloo's "Connection closed by peer"): above the
    #: 0.33-0.45 s an H100 host took from a SIGKILL to the visible exit
    #: of a rank holding a CUDA context
    PEER_GRACE_S = 2.0

    def __init__(self, world: int, *, device: str = "cuda",
                 threads: Optional[int] = None,
                 timeout_s: float = RANK_TIMEOUT_S):
        self.world = world
        self.device = device
        self.threads = threads
        self.timeout_s = timeout_s
        self._procs: List = []
        self._killed: Dict[int, float] = {}
        self._jid = 0

    def start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(list(PRELOAD))
        self._dir = tempfile.mkdtemp(prefix="rank_world_")
        store = os.path.join(self._dir, "store")
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(self.world)]
        self._killed = {}
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.world, store, self.device, self.threads,
                  self.timeout_s, self._jobs[r], self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()

    def kill(self, rank: int) -> None:
        """Send rank ``rank`` ``SIGKILL`` (a dead device): the job running
        raises ``RankFailure`` naming it as died."""
        self._killed[rank] = clock()
        os.kill(self._procs[rank].pid, signal.SIGKILL)

    def _dead(self) -> List[RankError]:
        """The ranks that exited, and those the parent killed (dead
        before their exit shows)."""
        out = []
        for r, p in enumerate(self._procs):
            code = p.exitcode
            if code is None and r in self._killed:
                code = -signal.SIGKILL
            if code is not None:
                out.append(RankError(r, "died", exitcode=code,
                                     signal=-code if code < 0 else None))
        return out

    def submit(self, fn: str, **kwargs) -> int:
        """Queue ``fn(ctx, **kwargs)`` on every rank; returns the job's
        id for ``collect``."""
        if not self._procs:
            self.start()
        self._jid += 1
        for q in self._jobs:
            q.put((self._jid, fn, kwargs))
        return self._jid

    def collect(self, jid: int, fn: str = "the job", *,
                timeout_s: Optional[float] = None) -> List[Any]:
        """Job ``jid``'s results in rank order; a failure raises
        ``RankFailure`` (every rank seen dead, raised or silent) and kills
        the world."""
        out: Dict[int, Any] = {}
        raised: Dict[int, RankError] = {}
        deadline = time.monotonic() + (timeout_s or self.timeout_s)
        first = None                  # when the first rank raised
        try:
            while len(out) < self.world:
                try:
                    got, rank, ok, val = self._results.get(timeout=0.05)
                except queue.Empty:
                    rank = None
                if rank is not None and ok and got == jid:
                    out[rank] = val
                elif rank is not None and not ok and got in (jid, None):
                    raised[rank] = RankError(
                        rank, "raised", traceback=val["traceback"],
                        stage_failure=val["stage_failure"])
                    first = first or time.monotonic()
                dead = self._dead()
                now = time.monotonic()
                if first is not None and not dead:
                    lost = any(_PEER_LOST.search(e.traceback)
                               for e in raised.values())
                    over = now > first + (self.PEER_GRACE_S if lost
                                          else self.GRACE_S)
                else:
                    over = False
                if dead or over:
                    errors = dead + [e for r, e in sorted(raised.items())
                                     if r not in {d.rank for d in dead}]
                    t_first = min((self._killed[e.rank] for e in dead
                                   if e.rank in self._killed),
                                  default=None)
                    raise RankFailure(
                        f"{fn}: " + "; ".join(e.describe() for e in errors)
                        + "".join(f"\n{e.traceback}" for e in errors
                                  if e.traceback), errors, t_first)
                if now > deadline:
                    errors = [raised.get(r) or RankError(r, "silent")
                              for r in sorted(set(range(self.world))
                                              - set(out))]
                    raise RankFailure(
                        f"{fn}: " + "; ".join(e.describe() for e in errors),
                        errors)
        except BaseException:
            self.close(kill=True)
            raise
        return [out[r] for r in range(self.world)]

    def run(self, fn: str, *, timeout_s: Optional[float] = None,
            **kwargs) -> List[Any]:
        """``fn(ctx, **kwargs)`` on every rank; the results in rank
        order."""
        return self.collect(self.submit(fn, **kwargs), fn,
                            timeout_s=timeout_s)

    def close(self, kill: bool = False) -> None:
        """End every rank and remove the store: ranks waiting for a job
        leave the world cleanly (a rank still busy after 10 s is killed);
        ``kill`` (a failed world) sends every rank ``SIGKILL`` at once and
        does not wait for the exits, which take a second or two where a
        rank holds a CUDA context: a failover re-plans and re-spawns
        meanwhile (``multiprocessing`` reaps them later)."""
        procs, self._procs = self._procs, []
        if not procs:
            return
        for q in self._jobs:
            q.put(None)
        if kill:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
        else:
            end = time.monotonic() + 10.0
            for p in procs:
                p.join(max(0.0, end - time.monotonic()))
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in alive:
                p.join()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
