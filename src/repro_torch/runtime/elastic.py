"""Elastic ring: stage failure -> Halda re-solve -> window remap -> resume
(a copy of ``repro.runtime.elastic``, over the port's ``RingPlan``).

The paper's A.5 shows the scheduler choosing device subsets; the same
machinery gives fault tolerance: when a stage dies, the survivors re-run
Halda over the reduced stage list, re-permute the layer stack for the new
(M', k', w') plan, and continue from the last token — KV state for the
lost stage's layers is rebuilt by a re-prefill of the conversation so far
(decode state is the only non-checkpointed state). In one process a
"failed stage" is the schedule's stage, reported by a ``StageFailure``;
across ranks it is the stage of a rank process that died or whose read
raised one (``runtime.failover``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from ..configs.base import ModelConfig
from ..core import halda
from ..core.profiles import DeviceProfile, ModelProfile
from ..core.ring import RingSchedule, build_schedule
from .serve import RingPlan, padded_layers


@dataclasses.dataclass
class ElasticState:
    stages: List[int]                  # surviving stage ids
    plan: RingPlan
    generation: int = 0


def initial_state(cfg: ModelConfig, n_stages: int, k: int = 1
                  ) -> ElasticState:
    return ElasticState(stages=list(range(n_stages)),
                        plan=RingPlan.make(cfg, n_stages, k=k))


def fail_stages(state: ElasticState, cfg: ModelConfig,
                failed: Sequence[int], *, k: Optional[int] = None
                ) -> ElasticState:
    """Drop failed stages and recompute the ring plan for the survivors."""
    survivors = [s for s in state.stages if s not in set(failed)]
    if not survivors:
        raise RuntimeError("all stages failed")
    M = len(survivors)
    if k is None:
        # keep per-stage layer count near the old plan: more rounds on a
        # smaller ring (the piped-ring knob the paper turns)
        per_stage = padded_layers(cfg.n_layers, M) // M
        k = max(1, min(state.plan.k * state.plan.w, per_stage))
        while per_stage % k:
            k -= 1
    plan = RingPlan.make(cfg, M, k=k)
    return ElasticState(stages=survivors, plan=plan,
                        generation=state.generation + 1)


def resolve_heterogeneous(devices: Sequence[DeviceProfile],
                          model: ModelProfile) -> halda.HaldaSolution:
    """Full Halda re-solve for heterogeneous survivors (reduced memory
    budgets, stragglers with degraded throughput, mixed stage sizes)."""
    return halda.solve(devices, model)


def remap_schedule(sol: halda.HaldaSolution, L: int) -> RingSchedule:
    """Concrete layer->window schedule for a Halda solution."""
    return build_schedule(sol.w, sol.n, L)
