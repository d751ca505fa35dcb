"""Piped-ring schedule construction (Section 3.1, Figure 1).

A copy of ``repro.core.ring``.

Given the Halda decision (w, n, k) over M ring devices, build the concrete
layer->(<device, round, backend>) schedule: device m processes a window of
w_m consecutive layers in each of the k rounds; windows are laid out in ring
order so every layer is covered exactly once per token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class WindowAssignment:
    device: int            # ring position m
    round: int             # 0..k-1
    layer_start: int       # first layer (inclusive)
    layer_end: int         # last layer (exclusive)
    n_resident: int        # layers on GPU / pinned in HBM (paper: n_m)

    @property
    def n_layers(self) -> int:
        return self.layer_end - self.layer_start

    @property
    def n_streamed(self) -> int:
        return self.n_layers - self.n_resident


@dataclasses.dataclass(frozen=True)
class RingSchedule:
    n_layers: int
    w: Tuple[int, ...]
    n: Tuple[int, ...]
    k: int
    windows: Tuple[WindowAssignment, ...]   # in execution (ring) order

    @property
    def n_devices(self) -> int:
        return len(self.w)

    def device_windows(self, m: int) -> List[WindowAssignment]:
        return [win for win in self.windows if win.device == m]

    def layer_owner(self, layer: int) -> WindowAssignment:
        for win in self.windows:
            if win.layer_start <= layer < win.layer_end:
                return win
        raise KeyError(layer)


def build_schedule(w: Sequence[int], n: Sequence[int], L: int) -> RingSchedule:
    """Lay windows around the ring; validates full single coverage.

    Devices with w_m == 0 (possible for baseline strategies like llama.cpp
    on a multi-device profile list) are skipped in the ring.
    """
    active = [m for m in range(len(w)) if w[m] > 0]
    if not active:
        raise ValueError("no active devices")
    W = sum(w)
    if L % W:
        raise ValueError(f"W={W} must divide L={L} (Assumption 1)")
    k = L // W
    windows: List[WindowAssignment] = []
    layer = 0
    for r in range(k):
        for m in active:
            # resident layers are the leading n_m of each window (the split
            # point is arbitrary for correctness; leading keeps the HBM-pinned
            # prefix contiguous for the streaming runtime).
            windows.append(WindowAssignment(
                device=m, round=r,
                layer_start=layer, layer_end=layer + w[m],
                n_resident=min(n[m], w[m])))
            layer += w[m]
    assert layer == L
    return RingSchedule(n_layers=L, w=tuple(w), n=tuple(n), k=k,
                        windows=tuple(windows))


def validate_schedule(s: RingSchedule) -> None:
    """Every layer exactly once; windows contiguous and ring-ordered."""
    covered = [0] * s.n_layers
    prev_end = 0
    for win in s.windows:
        assert win.layer_start == prev_end, "windows must be contiguous"
        prev_end = win.layer_end
        for l in range(win.layer_start, win.layer_end):
            covered[l] += 1
        assert 0 <= win.n_resident <= win.n_layers
    assert prev_end == s.n_layers
    assert all(c == 1 for c in covered), "layer covered more than once"
