"""Baseline layer-assignment strategies the paper compares against (§4).

A copy of ``repro.core.baselines`` (numpy), over the port's Halda and
latency model.

Each strategy returns (w, n, k) in the same decision space as Halda so the
simulator and the analytic latency model can score all systems uniformly.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from .halda import HaldaSolution
from .latency import classify_device, token_latency
from .profiles import DeviceProfile, ModelProfile


def _finish(devices, model, w, n, k) -> HaldaSolution:
    cases = [classify_device(d, i, model, w[i], n[i], k)
             for i, d in enumerate(devices)]
    return HaldaSolution(w=list(w), n=list(n), k=k, cases=cases,
                         latency=token_latency(devices, model, w, n, cases),
                         iterations=0)


def _proportional(weights: Sequence[float], L: int) -> List[int]:
    arr = np.asarray(weights, dtype=float)
    if arr.sum() <= 0:
        arr = np.ones(len(arr))
    w = np.maximum(np.floor(arr / arr.sum() * L), 1).astype(int)
    while w.sum() > L:
        w[int(np.argmax(w))] -= 1
    while w.sum() < L:
        w[int(np.argmax(arr / arr.sum() * L - w))] += 1
    return w.tolist()


def _gpu_layers_capacity(dev: DeviceProfile, model: ModelProfile,
                         w_m: int) -> int:
    if not dev.has_gpu:
        return 0
    per_layer = model.layer_bytes + model.kv_bytes_layer
    cap = int(max(dev.gpu_budget() - model.c_gpu, 0.0) // max(per_layer, 1.0))
    return min(w_m, cap)


def llama_cpp(devices: Sequence[DeviceProfile], model: ModelProfile
              ) -> HaldaSolution:
    """Single strongest device runs everything (on-device baseline).

    Matches the paper's setup: llama.cpp on the most powerful desktop, with
    as many layers as fit on its GPU and the rest on CPU/mmap.
    """
    def power(d: DeviceProfile) -> float:
        g = max(d.gpu_flops.values()) if d.gpu_flops else 0.0
        return max(max(d.cpu_flops.values()), g)

    best = max(range(len(devices)), key=lambda i: power(devices[i]))
    L = model.n_layers
    w = [0] * len(devices)
    n = [0] * len(devices)
    w[best] = L
    n[best] = _gpu_layers_capacity(devices[best], model, L)
    # single-device ring: k = 1 and only one participant
    sub = [devices[best]]
    sol = _finish(sub, model, [L], [n[best]], 1)
    return HaldaSolution(w=w, n=n, k=1, cases=[sol.cases[0]],
                         latency=sol.latency, iterations=0)


def exo(devices: Sequence[DeviceProfile], model: ModelProfile
        ) -> HaldaSolution:
    """exo: layers proportional to *total* device memory, k = 1.

    exo uses the GPU exclusively when present ("CPU / GPU" in Table 1) and
    keeps weights resident (no mmap) — OOM when a shard exceeds memory.
    """
    totals = []
    for d in devices:
        # total memory, not available: the paper notes exo splits by RAM size
        # (approximate total as available * 2 for home devices).
        t = (d.ram_avail * 2.0) + (d.vram_avail if d.has_cuda else 0.0)
        if d.has_metal:
            t = max(t, d.vram_avail * 1.5)
        totals.append(t)
    w = _proportional(totals, model.n_layers)
    n = [w[i] if d.has_gpu else 0 for i, d in enumerate(devices)]
    return _finish(devices, model, w, n, 1)


def dllama(devices: Sequence[DeviceProfile], model: ModelProfile
           ) -> HaldaSolution:
    """dllama: uniform split (tensor parallelism), CPU-only, k = 1.

    TP slices every layer evenly; latency-wise each device processes 1/M of
    every layer and an all-reduce per layer is paid. We model it in the
    layer-window space as a uniform split with an extra per-layer comm term
    folded into xi via the simulator's tp_allreduce flag.
    """
    M = len(devices)
    w = _proportional([1.0] * M, model.n_layers)
    n = [0] * M
    return _finish(devices, model, w, n, 1)


def prima_no_halda(devices: Sequence[DeviceProfile], model: ModelProfile
                   ) -> HaldaSolution:
    """Ablation (§4.2): exo's strategy improved with *available* RAM/VRAM
    and GPU->CPU offload of overloaded layers; k = 1."""
    avail = [d.memory_budget() for d in devices]
    w = _proportional(avail, model.n_layers)
    n = [_gpu_layers_capacity(d, model, w[i]) for i, d in enumerate(devices)]
    return _finish(devices, model, w, n, 1)


STRATEGIES = {
    "llama.cpp": llama_cpp,
    "exo": exo,
    "dllama": dllama,
    "prima(w/o halda)": prima_no_halda,
}
