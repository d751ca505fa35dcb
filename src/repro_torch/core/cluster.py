"""Device-subset selection (paper A.5) and elastic re-solve.

A copy of ``repro.core.cluster``.

The paper's recipe: start with all candidate devices, run Halda, drop the
devices the solver marks as drags (assigned only the forced minimum of one
layer / below a threshold), re-solve, and keep the best cluster found.
``select_cluster`` automates that loop — the "future updates will automate
this" the paper promises.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from . import halda
from .profiles import DeviceProfile, ModelProfile


@dataclasses.dataclass
class ClusterChoice:
    devices: List[int]                  # indices into the candidate list
    solution: halda.HaldaSolution
    history: List[Tuple[Tuple[int, ...], float]]


def select_cluster(candidates: Sequence[DeviceProfile],
                   model: ModelProfile, *,
                   min_layers: int = 2,
                   max_rounds: int = 8) -> ClusterChoice:
    """Iteratively drop drag devices (w_m < min_layers) and keep the best
    latency seen. The head device (index 0) is never dropped."""
    active = list(range(len(candidates)))
    best: Optional[ClusterChoice] = None
    history: List[Tuple[Tuple[int, ...], float]] = []

    for _ in range(max_rounds):
        devs = [candidates[i] for i in active]
        sol = halda.solve(devs, model)
        history.append((tuple(active), sol.latency))
        if best is None or sol.latency < best.solution.latency:
            best = ClusterChoice(devices=list(active), solution=sol,
                                 history=history)
        drags = [active[m] for m, w in enumerate(sol.w)
                 if w < min_layers and active[m] != 0]
        if not drags or len(active) <= 1:
            break
        # drop the single worst drag per round (paper: remove those with
        # one assigned layer; one-at-a-time keeps the search monotone)
        drop = min(
            (i for i in drags),
            key=lambda i: candidates[i].memory_budget())
        active = [i for i in active if i != drop]

    assert best is not None
    best.history = history
    return best


def fail_and_resolve(devices: Sequence[DeviceProfile],
                     model: ModelProfile, failed: Sequence[int]
                     ) -> halda.HaldaSolution:
    """Elastic path: drop failed devices, re-run Halda on the survivors."""
    survivors = [d for i, d in enumerate(devices) if i not in set(failed)]
    if not survivors:
        raise RuntimeError("no surviving devices")
    return halda.solve(survivors, model)
