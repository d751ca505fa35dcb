"""Event-driven piped-ring timeline simulator (Appendix A.1/A.2, Fig. 3-6).

A copy of ``repro.core.simulator`` (pure Python over the port's copied
profiles, latency model and ring schedule).

Simulates the decode loop at window granularity: compute, ring hops,
demand (page-fault) weight loading, and background prefetch — including the
prefetch-release effect when a device's streamed window exceeds its
reclaimable-memory budget.

The simulator is the measurement instrument for the reproduction benchmarks
(Table 3/4/6, Fig 2/8); the analytic model in ``latency.py`` is Halda's
objective. Tests assert the two agree in regimes where the paper's
worst-case assumption (no overlap) makes them comparable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .latency import (_sum_q, classify_device, device_coeffs,
                      expected_tokens_per_cycle)
from .profiles import Case, DeviceProfile, ModelProfile, OS
from .ring import RingSchedule, build_schedule


@dataclasses.dataclass
class SimResult:
    token_latency: float            # steady-state seconds/token
    ttft: float                     # first token completion time
    oom: bool = False
    per_device_busy: Dict[int, float] = dataclasses.field(default_factory=dict)
    per_device_disk: Dict[int, float] = dataclasses.field(default_factory=dict)
    memory_pressure: Dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def token_latency_ms(self) -> float:
        return self.token_latency * 1e3


@dataclasses.dataclass
class _DevState:
    budget: float          # reclaimable page-cache budget for streamed weights
    stream_bytes_total: float   # total streamed weight bytes on this device
    resident_ok: bool      # streamed set fits budget -> cached after warmup
    warm: bool = False     # whether the full streamed set has been read once
    prefetch_started: float = -1.0   # wall time background prefetch began
    prev_done: float = 0.0
    busy: float = 0.0
    disk: float = 0.0


def _window_compute_time(dev: DeviceProfile, model: ModelProfile,
                         n_cpu: int, n_gpu: int, is_head: bool,
                         seq: int = 1) -> float:
    """Compute + memory-access time for one window (seq tokens batched)."""
    t = 0.0
    if n_cpu:
        t += n_cpu * (_sum_q(model.flops_layer, dev.cpu_flops) * seq
                      + dev.t_kv_copy_cpu * seq
                      + model.b_prime / dev.cpu_membw)
    if n_gpu:
        t += n_gpu * (_sum_q(model.flops_layer, dev.gpu_flops) * seq
                      + dev.t_kv_copy_gpu * seq
                      + model.b_prime / max(dev.gpu_membw, 1.0))
    t += (dev.t_ram_vram + dev.t_vram_ram) * (0.0 if dev.uma else 1.0)
    return t


def _head_output_time(dev: DeviceProfile, model: ModelProfile,
                      seq: int = 1) -> float:
    """lm-head time; ``seq`` positions need logits per verify pass (the
    head weights stream once — only the matmul FLOPs scale)."""
    return (seq * _sum_q(model.flops_output, dev.cpu_flops)
            + model.head_extra_bytes() / dev.cpu_membw)


def simulate_ring(devices: Sequence[DeviceProfile], model: ModelProfile,
                  w: Sequence[int], n: Sequence[int], *,
                  prefetch: bool = True, n_tokens: int = 8,
                  prompt_len: int = 16, resident_weights: bool = False,
                  decode_seq: int = 1) -> SimResult:
    """Simulate piped-ring decode for an assignment.

    ``resident_weights=True`` models systems that keep weights in mem_used
    (exo/dllama): no mmap reclaim (no disk loads) but OOM when the shard
    exceeds device memory, and full memory pressure.

    ``decode_seq``: tokens scored per decode pass (1 = ordinary decode;
    gamma+1 = a speculative verify pass). Compute and KV terms scale with
    it; weight streaming — RAM *and* disk — is per pass, which is the
    whole speculative amortization. The returned ``token_latency`` is then
    seconds per *pass*, not per emitted token (see ``simulate_speculative``).
    """
    sched = build_schedule(w, n, model.n_layers)
    active = sorted({win.device for win in sched.windows})
    states: Dict[int, _DevState] = {}
    pressure: Dict[int, float] = {}
    oom = False

    for m in active:
        dev = devices[m]
        k = sched.k
        n_cpu_layers = k * (w[m] - n[m])
        kv_cpu = n_cpu_layers * model.kv_bytes_layer
        kv_gpu = k * n[m] * model.kv_bytes_layer
        stream = n_cpu_layers * model.layer_bytes
        head_extra = model.head_extra_bytes() if m == active[0] else 0.0
        # mem_total estimate: home devices are >= 8 GiB; mem_available is
        # what's left after the OS/apps (paper's pressure denominator).
        ram_total = max(dev.ram_avail * 2.0, 8.0 * (1 << 30))

        if resident_weights:
            shard = k * w[m] * model.layer_bytes
            gpu_shard = min(shard, dev.gpu_budget())
            cpu_resident = shard - gpu_shard + kv_cpu + model.c_cpu
            if (cpu_resident > dev.ram_avail * 1.5
                    or gpu_shard > dev.gpu_budget() + 1e-9 and not dev.has_gpu):
                oom = True
            pressure[m] = min(cpu_resident / ram_total, 1.0)
            states[m] = _DevState(budget=math.inf, stream_bytes_total=0.0,
                                  resident_ok=True, warm=True)
            continue

        # mmap path: only KV + buffers are non-reclaimable pressure.
        pressure[m] = min((kv_cpu + kv_gpu * (1.0 if dev.uma else 0.0)
                           + model.c_cpu + head_extra) / ram_total, 0.99)
        budget = max(dev.ram_avail - model.c_cpu - head_extra - kv_cpu, 0.0)
        if dev.os == OS.ANDROID:
            budget += min(dev.bytes_can_swap, dev.swap_avail)
        if dev.os == OS.MACOS and dev.has_metal:
            # macOS+Metal (paper case 2): when the *whole* working set
            # exceeds the recommended Metal budget, the OS evicts mmap-ed
            # weights aggressively and every assigned layer reloads —
            # including the "GPU" layers (UMA shared pool).
            total_need = (k * w[m] * model.layer_bytes
                          + (kv_cpu + kv_gpu) + model.c_cpu + model.c_gpu
                          + head_extra)
            if total_need > dev.vram_avail:
                stream = k * w[m] * model.layer_bytes
                budget = max(dev.vram_avail - model.c_cpu - model.c_gpu
                             - (kv_cpu + kv_gpu) - head_extra, 0.0)
        states[m] = _DevState(budget=budget, stream_bytes_total=stream,
                              resident_ok=stream <= budget)

    head = active[0]
    completions: List[float] = []
    t_clock = 0.0

    for tok in range(n_tokens):
        seq = prompt_len if tok == 0 else decode_seq
        arrival = t_clock
        for win in sched.windows:
            m = win.device
            dev = devices[m]
            st = states[m]
            start = max(arrival, st.prev_done)

            # -- disk loading for the streamed part of this window ---------
            metal_full = (dev.os == OS.MACOS and dev.has_metal
                          and not st.resident_ok
                          and st.stream_bytes_total > 0)
            win_stream = win.n_streamed * model.layer_bytes
            if metal_full:
                win_stream = win.n_layers * model.layer_bytes
            stall = 0.0
            if win_stream > 0 and not st.resident_ok:
                # prefetch-release: window bigger than the page-cache budget
                # means background prefetch evicted itself (A.1).
                release = win_stream > st.budget
                per_token_reload = max(
                    st.stream_bytes_total - st.budget, 0.0)
                # paper eq. (15): only the excess over the budget re-loads;
                # distribute over this device's k windows.
                need = per_token_reload / max(sched.k, 1) \
                    if not release else win_stream
                need = min(need, win_stream)
                # background prefetch overlapped since this device's last
                # window (other stages' compute hides it; paper Fig. 6)
                useful = 0.0
                if prefetch and not release and st.prefetch_started >= 0.0:
                    gap = max(start - st.prefetch_started, 0.0)
                    useful = min(dev.disk_speed() * gap, need)
                demand = max(need - useful, 0.0)
                stall = demand / dev.disk_speed()
                st.disk += need / dev.disk_speed()
            elif win_stream > 0 and not st.warm:
                stall = win_stream / dev.disk_speed()  # cold first read
                st.disk += stall

            comp = _window_compute_time(dev, model, win.n_streamed,
                                        win.n_resident, m == head, seq)
            done = start + stall + comp
            st.busy += stall + comp
            st.prev_done = done
            st.prefetch_started = done if (prefetch
                                           and not st.resident_ok) else -1.0
            arrival = done + dev.t_comm

        # output layer back on the head device (prefill emits one logit
        # row; a decode pass emits decode_seq of them)
        head_dev = devices[head]
        arrival = max(arrival, states[head].prev_done)
        out_done = arrival + _head_output_time(
            head_dev, model, 1 if tok == 0 else decode_seq)
        states[head].prev_done = out_done
        completions.append(out_done)
        t_clock = out_done
        for m in active:
            if states[m].stream_bytes_total > 0:
                states[m].warm = True

    if len(completions) >= 3:
        steady = (completions[-1] - completions[1]) / (len(completions) - 2)
    else:
        steady = completions[-1] / max(len(completions), 1)
    busy = {m: states[m].busy for m in active}
    disk = {m: states[m].disk for m in active}
    return SimResult(token_latency=steady, ttft=completions[0], oom=oom,
                     per_device_busy=busy, per_device_disk=disk,
                     memory_pressure=pressure)


@dataclasses.dataclass
class SpecSimResult:
    """Speculative-decoding timeline result (per *emitted* token)."""

    token_latency: float            # expected seconds per emitted token
    tps: float                      # expected emitted tokens/s
    cycle_latency: float            # verify pass + draft steps
    verify_latency: float           # ring pass scoring gamma+1 positions
    draft_latency: float            # gamma+1 draft decodes per cycle
    tokens_per_cycle: float         # E[emitted] at the acceptance rate
    base: SimResult                 # underlying ring simulation (per pass)

    @property
    def token_latency_ms(self) -> float:
        return self.token_latency * 1e3


def simulate_speculative(devices: Sequence[DeviceProfile],
                         model: ModelProfile, w: Sequence[int],
                         n: Sequence[int], *, gamma: int,
                         acceptance: float, draft_token_latency: float,
                         prefetch: bool = True, n_cycles: int = 8,
                         prompt_len: int = 16) -> SpecSimResult:
    """Speculative decode on the ring timeline.

    Each cycle runs gamma+1 draft decodes (resident on the head device —
    ``draft_token_latency`` per step, measured or modelled separately) and
    ONE (gamma+1)-token verify pass through the pipelined ring; the pass
    streams each window's weights once, so its cost is far below gamma+1
    single-token passes on these disk/bandwidth-bound clusters. Emitted
    tokens per cycle follow the acceptance model
    (``expected_tokens_per_cycle``); the effective TPOT divides the cycle
    time by it.
    """
    base = simulate_ring(devices, model, w, n, prefetch=prefetch,
                         n_tokens=n_cycles, prompt_len=prompt_len,
                         decode_seq=gamma + 1)
    e = expected_tokens_per_cycle(acceptance, gamma)
    t_draft = (gamma + 1) * draft_token_latency
    cycle = base.token_latency + t_draft
    return SpecSimResult(token_latency=cycle / e, tps=e / cycle,
                         cycle_latency=cycle,
                         verify_latency=base.token_latency,
                         draft_latency=t_draft, tokens_per_cycle=e,
                         base=base)


def simulate_tp(devices: Sequence[DeviceProfile], model: ModelProfile, *,
                n_tokens: int = 8, prompt_len: int = 16) -> SimResult:
    """dllama-style uniform tensor parallelism: every device computes 1/M of
    every layer, with an all-reduce barrier per layer (CPU backend, resident
    weights, Q40-style)."""
    M = len(devices)
    L = model.n_layers
    pressure: Dict[int, float] = {}
    oom = False
    for m, dev in enumerate(devices):
        shard = L * model.layer_bytes / M + L * model.kv_bytes_layer / M \
            + model.c_cpu
        ram_total = dev.ram_avail * 2.0
        pressure[m] = min(shard / ram_total, 1.0)
        if shard > dev.ram_avail * 1.5:
            oom = True

    completions = []
    t = 0.0
    for tok in range(n_tokens):
        seq = prompt_len if tok == 0 else 1
        for layer in range(L):
            per_dev = [(_sum_q(model.flops_layer, d.cpu_flops) * seq / M
                        + (model.b_prime / M) / d.cpu_membw
                        + d.t_kv_copy_cpu * seq)
                       for d in devices]
            # two all-reduce barriers per layer (attention out + MLP out,
            # Megatron-style TP): slowest device + round-trips
            t += max(per_dev) + 2.0 * 2.0 * max(d.t_comm for d in devices)
        t += _head_output_time(devices[0], model)
        completions.append(t)
    steady = ((completions[-1] - completions[1]) / (len(completions) - 2)
              if len(completions) >= 3 else completions[-1])
    return SimResult(token_latency=steady, ttft=completions[0], oom=oom,
                     memory_pressure=pressure)
