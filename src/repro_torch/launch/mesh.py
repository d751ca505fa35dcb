"""The port's ring layout: M pipeline stages of the piped ring on one
device.

The JAX package lays the ring over a ("data", "model") device mesh: one
stage per "data" coordinate, a tensor-parallel group of "model" chips
inside it. The port runs every stage in one process on one card (each
stage with its own rows of the layer bank and its own slice of the cache,
the ring hop a hand-off between stages), so its layout is the stage
count, the tensor-parallel width (1: tensor parallelism inside a stage is
ROADMAP Queue A item 6) and the device.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RingLayout:
    n_stages: int
    tp: int
    device: torch.device


def make_ring_layout(n_stages: int = 4, tp: int = 1,
                     device="cuda") -> RingLayout:
    """The layout of an ``n_stages`` ring on ``device``. ``tp`` must be 1:
    a tensor-parallel group inside a stage needs one device per member
    (ROADMAP Queue A item 6)."""
    if tp != 1:
        raise ValueError(f"tp={tp}: the port's ring runs each stage on one "
                         f"device (tp=1); tensor parallelism inside a stage "
                         f"is ROADMAP Queue A item 6")
    if n_stages < 1:
        raise ValueError(f"n_stages={n_stages}: a ring needs a stage")
    return RingLayout(n_stages=n_stages, tp=1, device=torch.device(device))
