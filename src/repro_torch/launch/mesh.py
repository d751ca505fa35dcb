"""The port's ring layouts: M pipeline stages of the piped ring on one
device, or one rank a (pod, stage, member) across processes.

The JAX package lays the ring over a ("pod", "data", "model") device
mesh: one stage per "data" coordinate, a tensor-parallel group of "model"
chips inside it, each pod a replica over its part of the batch.

``make_ring_layout`` is the one-process ring: every stage in one process
on one card (each stage with its own rows of the layer bank and its own
slice of the cache, the ring hop a hand-off between stages), so its
layout is the stage count, tp = 1 and the device.

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
stages). Nothing runs on the global default group.

``RankWorld`` spawns the ranks (``torch.multiprocessing``, start method
``spawn``) and runs jobs on all of them: ``"module:function"`` called as
``function(ctx, **kwargs)`` on each rank with a ``RankContext``; the
serve driver runs one job, the tests a world a module.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..runtime.collectives import Axis

#: seconds a collective waits for its peers before the rank fails
RANK_TIMEOUT_S = 300.0


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
                         f"across ranks (make_rank_layout), and the streamed "
                         f"ring and failover across ranks are ROADMAP Queue "
                         f"A item 6")
    if n_stages < 1:
        raise ValueError(f"n_stages={n_stages}: a ring needs a stage")
    return RingLayout(n_stages=n_stages, tp=1, device=torch.device(device))


# --------------------------------------------------------------------------- #
#  the ring across ranks
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class RankLayout:
    """One rank of a ``pods x n_stages x tp`` ring: its coordinates, its
    device and its two groups (``model``: its stage's members, in member
    order; ``ring``: its member's stages in its pod, in stage order)."""
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
        self.model.tracer = tracer
        self.ring.tracer = tracer


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
    groups = {tuple(r): _group(r, timeout_s)
              for r in model_ranks + ring_ranks}
    pod, stage, member = rank_coords(rank, n_stages, tp)
    mine = model_ranks[pod * n_stages + stage]
    ring = ring_ranks[pod * tp + member]
    return RankLayout(
        pods=pods, n_stages=n_stages, tp=tp, rank=rank, pod=pod,
        stage=stage, member=member, device=torch.device(device),
        model=Axis("model", groups[tuple(mine)], tuple(mine), member),
        ring=Axis("data", groups[tuple(ring)], tuple(ring), stage))


@dataclasses.dataclass
class RankContext:
    """What a job gets on its rank: the rank, the world's size, the
    rank's device and the collectives' timeout."""
    rank: int
    world: int
    device: str
    timeout_s: float

    def layout(self, n_stages: int, tp: int, pods: int = 1) -> RankLayout:
        return make_rank_layout(n_stages, tp, pods, rank=self.rank,
                                device=self.device,
                                timeout_s=self.timeout_s)


def _resolve(fn: str):
    module, name = fn.split(":")
    return getattr(importlib.import_module(module), name)


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
    except BaseException:                       # noqa: BLE001
        results.put((None, rank, False, traceback.format_exc()))
        return
    ctx = RankContext(rank, world, device, timeout_s)
    while True:
        job = jobs.get()
        if job is None:
            break
        jid, fn, kwargs = job
        try:
            out = _resolve(fn)(ctx, **kwargs)
            results.put((jid, rank, True, out))
        except BaseException:                   # noqa: BLE001
            results.put((jid, rank, False, traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class RankFailure(RuntimeError):
    """A rank raised, died or did not answer in time."""


class RankWorld:
    """``world`` rank processes (start method ``spawn``) joined over gloo,
    running jobs: ``run("module:function", **kwargs)`` calls
    ``function(ctx, **kwargs)`` on every rank and returns the results in
    rank order. A rank that raises, dies or outlasts ``timeout_s`` makes
    ``run`` raise ``RankFailure`` and ends the world (the next ``run``
    starts a new one). Every rank runs on ``device``; ``threads``: torch
    threads a rank."""

    def __init__(self, world: int, *, device: str = "cuda",
                 threads: Optional[int] = None,
                 timeout_s: float = RANK_TIMEOUT_S):
        self.world = world
        self.device = device
        self.threads = threads
        self.timeout_s = timeout_s
        self._procs: List = []
        self._jid = 0

    def start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="rank_world_")
        store = os.path.join(self._dir, "store")
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(self.world)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.world, store, self.device, self.threads,
                  self.timeout_s, self._jobs[r], self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()

    def run(self, fn: str, *, timeout_s: Optional[float] = None,
            **kwargs) -> List[Any]:
        """``fn(ctx, **kwargs)`` on every rank; the results in rank
        order."""
        if not self._procs:
            self.start()
        self._jid += 1
        jid = self._jid
        for q in self._jobs:
            q.put((jid, fn, kwargs))
        out: Dict[int, Any] = {}
        deadline = time.monotonic() + (timeout_s or self.timeout_s)
        try:
            while len(out) < self.world:
                try:
                    got, rank, ok, val = self._results.get(timeout=0.2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if p.exitcode is not None]
                    if dead:
                        raise RankFailure(
                            f"rank(s) {dead} exited (codes "
                            f"{[self._procs[r].exitcode for r in dead]}) "
                            f"during {fn}")
                    if time.monotonic() > deadline:
                        raise RankFailure(f"{fn}: no answer from rank(s) "
                                          f"{sorted(set(range(self.world)) - set(out))} "
                                          f"in time")
                    continue
                if not ok:
                    raise RankFailure(f"rank {rank} failed in {fn}:\n{val}")
                if got == jid:
                    out[rank] = val
        except BaseException:
            self.close(kill=True)
            raise
        return [out[r] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        """End every rank (ranks waiting for a job leave the world
        cleanly; ``kill``, or a rank still busy after 10 s: killed) and
        remove the store."""
        procs, self._procs = self._procs, []
        if not procs:
            return
        for q in self._jobs:
            q.put(None)
        end = time.monotonic() + (0.0 if kill else 10.0)
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
