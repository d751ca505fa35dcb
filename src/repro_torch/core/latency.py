"""Token-latency model (paper Appendix A.3, eqs. 11-21) and case logic.

A copy of ``repro.core.latency`` (pure analytic modelling, numpy only). These functions are
shared by the Halda scheduler (which linearizes them into ILP coefficients)
and by the benchmarks (which evaluate candidate assignments).

Conventions (decode, single request, steady state):
  w[m] : layer window size on device m          (decision)
  n[m] : GPU layers inside the window on m      (decision)
  k    : rounds per token, k = L / sum(w)
  l_m  = k * w[m]   total layers on device m    (Assumption 1, R = 0)
  l_m^gpu = k * n[m]
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .profiles import Case, DeviceProfile, ModelProfile, OS

#: Disk speed below which overloading a device is never worthwhile (paper's
#: s^disk_threshold). Tuned to the Table-2 cluster: the Mac Air's 0.39 GB/s
#: disk lands below, the phones' UFS above.
DISK_SPEED_THRESHOLD = 0.30e9


def _sum_q(flops: Dict[str, float], speed: Dict[str, float]) -> float:
    """sum_q f^q / s^q over quant formats present in the model file."""
    total = 0.0
    for q, f in flops.items():
        s = speed.get(q)
        if s is None or s <= 0.0:
            s = max(speed.values()) if speed else 1e9
        total += f / s
    return total


@dataclasses.dataclass(frozen=True)
class DeviceCoeffs:
    """Per-device linearized latency coefficients (paper A.3)."""

    alpha: float   # per-CPU-layer latency  (compute + kv copy + mem load)
    beta: float    # delta per layer moved to GPU (usually negative)
    xi: float      # per-window overhead (PCIe copies + ring hop)


# ---------------------------------------------------------------------------
# Memoized per-cluster coefficient table (numpy vectorization)
# ---------------------------------------------------------------------------
#
# ``token_latency``/``ttft`` sit inside Halda's k-enumeration fixed point
# (and its 2^M case enumeration), so the per-device Python loops are a
# measured hot spot of ``benchmarks/halda_scaling.py``. All per-device
# quantities are static for a (devices, model) pair; we extract them ONCE
# into (M,)-shaped numpy arrays keyed by a value signature (profiles are
# frozen dataclasses) and evaluate the latency model as pure array math.
#
# The compute/KV terms are additionally split from the weight-streaming
# terms so the same table prices *multi-token* verify passes (speculative
# decoding): FLOPs, KV copies and KV memory reads scale with the tokens
# per pass, while weight streaming (RAM and disk) is paid once — the
# amortization that makes batched verification win on these clusters.

def _sig_dev(d: DeviceProfile) -> tuple:
    return (d.name, d.os, d.ram_avail, d.vram_avail, d.swap_avail,
            d.bytes_can_swap, d.has_metal, d.has_cuda, d.uma,
            d.cpu_membw, d.gpu_membw, d.t_kv_copy_cpu, d.t_kv_copy_gpu,
            d.t_ram_vram, d.t_vram_ram, d.disk_seq_bps, d.disk_rand_bps,
            d.t_comm, tuple(sorted(d.cpu_flops.items())),
            tuple(sorted(d.gpu_flops.items())))


def _sig_model(m: ModelProfile) -> tuple:
    return (m.name, m.n_layers, m.layer_bytes, m.input_bytes,
            m.output_bytes, m.embed_dim, m.vocab, m.kv_heads, m.head_dim,
            m.n_kv, tuple(sorted(m.flops_layer.items())),
            tuple(sorted(m.flops_output.items())), m.c_cpu, m.c_gpu,
            m.state_bytes)


@dataclasses.dataclass(frozen=True)
class _CoeffTable:
    """Per-device (M,) arrays for the vectorized latency model."""

    # alpha/gpu split: <term>(seq) = seq * <x>_seq + <x>_fix
    cpu_seq: np.ndarray      # per-layer CPU flops + kv copy + kv membw
    cpu_fix: np.ndarray      # per-layer weight membw (streamed once/pass)
    gpu_seq: np.ndarray
    gpu_fix: np.ndarray
    has_gpu: np.ndarray      # bool
    xi: np.ndarray           # per-window overhead
    disk: np.ndarray         # effective reload bytes/s
    swap: np.ndarray         # usable Android swap
    ram: np.ndarray
    vram: np.ndarray
    macos_nometal: np.ndarray    # bool masks for the case logic
    macos_metal: np.ndarray
    slow_disk: np.ndarray
    # classification shortcut: per-device overload case code (M4 for
    # slow-disk devices), memory budget, and the w/n-independent part of
    # the working-set size (head bytes + compute buffers)
    over_case: np.ndarray
    budget: np.ndarray
    need_const: np.ndarray
    count_gpu_resident: np.ndarray   # 1.0 where GPU layers escape RAM (M3)
    # objective shortcut: per-case disk coefficients and kappa terms
    bprime_disk: np.ndarray      # b' / disk
    lb_disk: np.ndarray          # layer_bytes / disk
    kappa_m1: np.ndarray         # (c_cpu - ram) / disk
    kappa_m3: np.ndarray         # (c_cpu - ram - swap) / disk
    xi_sum: float
    # raw per-device rates (ttft's prefill terms)
    cpu_flops_t: np.ndarray      # sum_q flops_layer / cpu_flops
    gpu_flops_t: np.ndarray      # same on GPU (0 where no GPU)
    membw: np.ndarray            # cpu_membw
    # head-device scalars (+ seq-scaling output compute)
    head_out_flops: float
    head_fixed: float        # lm-head membw + embedding-row disk read
    head_out_disk: float     # output_bytes / disk (paid unless head is M4)


_TABLES: Dict[tuple, _CoeffTable] = {}
#: id-based fast path. Entries pin strong references to their profile
#: objects, so a cached id can never be recycled for a different profile.
_TABLES_BY_ID: Dict[tuple, tuple] = {}


def _coeff_table(devices: Sequence[DeviceProfile], model: ModelProfile
                 ) -> _CoeffTable:
    id_key = (tuple(id(d) for d in devices), id(model))
    hit = _TABLES_BY_ID.get(id_key)
    if hit is not None:
        return hit[2]
    key = (tuple(_sig_dev(d) for d in devices), _sig_model(model))
    tab = _TABLES.get(key)
    if tab is not None:
        if len(_TABLES_BY_ID) > 256:
            _TABLES_BY_ID.clear()
        _TABLES_BY_ID[id_key] = (list(devices), model, tab)
        return tab

    kv_bytes = model.kv_bytes_layer
    cpu_seq, cpu_fix, gpu_seq, gpu_fix = [], [], [], []
    has_gpu, xi, disk, swap, ram, vram = [], [], [], [], [], []
    mac_nm, mac_m, slow = [], [], []
    cpu_ft, gpu_ft, membw = [], [], []
    for dev in devices:
        cpu_ft.append(_sum_q(model.flops_layer, dev.cpu_flops))
        membw.append(dev.cpu_membw)
        cpu_seq.append(cpu_ft[-1] + dev.t_kv_copy_cpu
                       + kv_bytes / dev.cpu_membw)
        cpu_fix.append(model.layer_bytes / dev.cpu_membw)
        if dev.has_gpu and dev.gpu_flops:
            gbw = max(dev.gpu_membw, 1.0)
            gpu_ft.append(_sum_q(model.flops_layer, dev.gpu_flops))
            gpu_seq.append(gpu_ft[-1] + dev.t_kv_copy_gpu + kv_bytes / gbw)
            gpu_fix.append(model.layer_bytes / gbw)
            has_gpu.append(True)
        else:
            gpu_ft.append(0.0)
            gpu_seq.append(0.0)
            gpu_fix.append(0.0)
            has_gpu.append(False)
        xi.append((dev.t_ram_vram + dev.t_vram_ram)
                  * (0.0 if dev.uma else 1.0) + dev.t_comm)
        disk.append(dev.disk_speed())
        swap.append(min(dev.bytes_can_swap, dev.swap_avail)
                    if dev.os == OS.ANDROID else 0.0)
        ram.append(dev.ram_avail)
        vram.append(dev.vram_avail)
        mac_nm.append(dev.os == OS.MACOS and not dev.has_metal)
        mac_m.append(dev.os == OS.MACOS and dev.has_metal)
        slow.append(dev.disk_speed() < DISK_SPEED_THRESHOLD)

    head = devices[0]
    disk_a = np.asarray(disk)
    ram_a = np.asarray(ram)
    vram_a = np.asarray(vram)
    swap_a = np.asarray(swap)
    mac_nm_a = np.asarray(mac_nm)
    mac_m_a = np.asarray(mac_m)
    macos = mac_nm_a | mac_m_a
    over_case = np.where(mac_nm_a, int(Case.M1),
                         np.where(mac_m_a, int(Case.M2), int(Case.M3)))
    over_case = np.where(np.asarray(slow), int(Case.M4), over_case)
    budget = np.where(mac_nm_a, ram_a,
                      np.where(mac_m_a, vram_a, ram_a + swap_a))
    need_const = np.full(len(devices), model.c_cpu)
    need_const[0] += model.head_extra_bytes()
    need_const += np.where(mac_m_a, model.c_gpu, 0.0)
    tab = _CoeffTable(
        cpu_seq=np.asarray(cpu_seq), cpu_fix=np.asarray(cpu_fix),
        gpu_seq=np.asarray(gpu_seq), gpu_fix=np.asarray(gpu_fix),
        has_gpu=np.asarray(has_gpu), xi=np.asarray(xi),
        disk=disk_a, swap=swap_a, ram=ram_a, vram=vram_a,
        macos_nometal=mac_nm_a, macos_metal=mac_m_a,
        slow_disk=np.asarray(slow),
        over_case=over_case.astype(int), budget=budget,
        need_const=need_const,
        count_gpu_resident=np.where(macos, 0.0, 1.0),
        bprime_disk=model.b_prime / disk_a,
        lb_disk=model.layer_bytes / disk_a,
        kappa_m1=(model.c_cpu - ram_a) / disk_a,
        kappa_m3=(model.c_cpu - ram_a - swap_a) / disk_a,
        xi_sum=float(np.sum(xi)),
        cpu_flops_t=np.asarray(cpu_ft), gpu_flops_t=np.asarray(gpu_ft),
        membw=np.asarray(membw),
        head_out_flops=_sum_q(model.flops_output, head.cpu_flops),
        head_fixed=(model.head_extra_bytes() / head.cpu_membw
                    + (model.input_bytes / model.vocab)
                    / head.disk_speed()),
        head_out_disk=model.output_bytes / head.disk_speed(),
    )
    if len(_TABLES) > 64:        # bound the memo (benchmark sweeps)
        _TABLES.clear()
        _TABLES_BY_ID.clear()
    _TABLES[key] = tab
    _TABLES_BY_ID[id_key] = (list(devices), model, tab)
    return tab


def classify_cases(devices: Sequence[DeviceProfile], model: ModelProfile,
                   w: Sequence[int], n: Sequence[int], k: int,
                   forced_m4: Optional[Sequence[bool]] = None) -> np.ndarray:
    """Vectorized ``classify_device`` over the cluster: (M,) int codes.

    Every case compares the device's would-be working set against its
    memory budget; only which layers count (all vs CPU-streamed) and the
    budget (RAM / Metal pool / RAM+swap) differ per OS — both precomputed
    in the coefficient table, so this is a handful of array ops.
    """
    tab = _coeff_table(devices, model)
    kvb = model.kv_bytes_per_token_layer * model.n_kv + model.state_bytes
    eff_l = k * (np.asarray(w, dtype=float)
                 - tab.count_gpu_resident * np.asarray(n, dtype=float))
    need = eff_l * (model.layer_bytes + kvb) + tab.need_const
    cases = np.where(need > tab.budget, tab.over_case, int(Case.M4))
    if forced_m4 is not None:
        cases = np.where(np.asarray(forced_m4, dtype=bool), int(Case.M4),
                         cases)
    return cases


def device_coeffs(dev: DeviceProfile, model: ModelProfile) -> DeviceCoeffs:
    b_prime = model.b_prime
    alpha = (_sum_q(model.flops_layer, dev.cpu_flops)
             + dev.t_kv_copy_cpu
             + b_prime / dev.cpu_membw)
    if dev.has_gpu and dev.gpu_flops:
        gpu_term = (_sum_q(model.flops_layer, dev.gpu_flops)
                    + dev.t_kv_copy_gpu
                    + b_prime / max(dev.gpu_membw, 1.0))
        beta = gpu_term - alpha
    else:
        beta = 0.0
    xi = (dev.t_ram_vram + dev.t_vram_ram) * (0.0 if dev.uma else 1.0) \
        + dev.t_comm
    return DeviceCoeffs(alpha=alpha, beta=beta, xi=xi)


# ---------------------------------------------------------------------------
# Case assignment (Section 3.2 Cases 1-4)
# ---------------------------------------------------------------------------

def b_cio(dev_index: int, model: ModelProfile) -> float:
    """(b_i/V + b_o) * I[m==head] + c^cpu   (eq. 34)."""
    extra = model.head_extra_bytes() if dev_index == 0 else 0.0
    return extra + model.c_cpu


def classify_device(dev: DeviceProfile, dev_index: int, model: ModelProfile,
                    w_m: int, n_m: int, k: int,
                    forced_m4: bool = False) -> Case:
    """Assign device to M1..M4 given the current decision variables."""
    if forced_m4:
        return Case.M4
    if dev.disk_speed() < DISK_SPEED_THRESHOLD:
        return Case.M4
    l_m = k * w_m
    l_gpu = k * n_m
    kvb = model.kv_bytes_per_token_layer * model.n_kv + model.state_bytes
    head = model.head_extra_bytes() if dev_index == 0 else 0.0
    if dev.os == OS.MACOS and not dev.has_metal:
        need = l_m * model.layer_bytes + head + kvb * l_m + model.c_cpu
        return Case.M1 if need > dev.ram_avail else Case.M4
    if dev.os == OS.MACOS and dev.has_metal:
        need = (l_m * model.layer_bytes + head + kvb * l_m
                + model.c_cpu + model.c_gpu)
        return Case.M2 if need > dev.vram_avail else Case.M4
    # Linux / Android / TPU stage: only the CPU-side (streamed) layers can
    # overload RAM; CUDA/HBM-resident layers are pinned by the driver.
    swap = 0.0
    if dev.os == OS.ANDROID:
        swap = min(dev.bytes_can_swap, dev.swap_avail)
    need = (l_m - l_gpu) * (model.layer_bytes + kvb) + head + model.c_cpu
    return Case.M3 if need > dev.ram_avail + swap else Case.M4


# ---------------------------------------------------------------------------
# Objective coefficient vectors a, b, c and constant kappa (Definition 1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ObjectiveData:
    """Vectorized LDA coefficients for a fixed case assignment."""

    a: List[float]          # coefficient of w_m
    b: List[float]          # coefficient of n_m
    c: List[float]          # constant per device (xi)
    kappa: float            # global constant
    cases: List[Case]
    # memory bounds, already divided by (L * b'): constraint (4)-(5) use
    # z * W with W = sum(w).
    z_ram: List[float]      # per-device RAM bound (sign per case)
    z_gpu: List[float]      # per-device VRAM bound


def build_objective(devices: Sequence[DeviceProfile], model: ModelProfile,
                    cases: Sequence[Case]) -> ObjectiveData:
    L = model.n_layers
    b_prime = model.b_prime
    a: List[float] = []
    b: List[float] = []
    c: List[float] = []
    z_ram: List[float] = []
    z_gpu: List[float] = []
    kappa = 0.0

    # Head-device constants (output layer runs on CPU of device 1).
    head = devices[0]
    kappa += _sum_q(model.flops_output, head.cpu_flops)
    kappa += model.head_extra_bytes() / head.cpu_membw
    kappa += (model.input_bytes / model.vocab) / head.disk_speed()
    if cases[0] != Case.M4:
        kappa += model.output_bytes / head.disk_speed()

    for i, (dev, case) in enumerate(zip(devices, cases)):
        co = device_coeffs(dev, model)
        sdisk = dev.disk_speed()
        if case == Case.M1:
            a.append(co.alpha + b_prime / sdisk)
            b.append(0.0)
            kappa += (model.c_cpu - dev.ram_avail) / sdisk
        elif case == Case.M2:
            a.append(co.alpha + model.layer_bytes / sdisk)
            b.append(co.beta)
        elif case == Case.M3:
            swap = (min(dev.bytes_can_swap, dev.swap_avail)
                    if dev.os == OS.ANDROID else 0.0)
            a.append(co.alpha + b_prime / sdisk)
            b.append(co.beta - b_prime / sdisk)
            kappa += (model.c_cpu - dev.ram_avail - swap) / sdisk
        else:  # M4
            a.append(co.alpha)
            b.append(co.beta)
        c.append(co.xi)

        # RAM bound (constraints 28-33), normalized by (L b').
        bc = b_cio(i, model)
        swap = (min(dev.bytes_can_swap, dev.swap_avail)
                if dev.os == OS.ANDROID else 0.0)
        if case == Case.M2:
            bound = (dev.vram_avail - bc - model.c_gpu) / (L * b_prime)
        elif dev.os == OS.MACOS and dev.has_metal:
            bound = (dev.vram_avail - bc - model.c_gpu) / (L * b_prime)
        else:
            bound = (dev.ram_avail + swap - bc) / (L * b_prime)
        z_ram.append(bound)

        # VRAM bound (constraints 35-36).
        if dev.has_cuda:
            g = (dev.vram_avail - model.c_gpu) / (L * b_prime)
        elif dev.has_metal:
            bo = model.output_bytes if i == 0 else 0.0
            g = (dev.vram_avail - model.c_gpu - bo) / (L * b_prime)
        else:
            g = 0.0
        z_gpu.append(max(g, 0.0))

    return ObjectiveData(a=a, b=b, c=c, kappa=kappa, cases=list(cases),
                         z_ram=z_ram, z_gpu=z_gpu)


def token_latency(devices: Sequence[DeviceProfile], model: ModelProfile,
                  w: Sequence[int], n: Sequence[int],
                  cases: Optional[Sequence[Case]] = None, *,
                  seq: int = 1) -> float:
    """Analytic per-step latency T for an assignment (objective (1)).

    Vectorized over devices (numpy; memoized coefficient table) — this
    sits inside Halda's k-enumeration loop and the 2^M case enumeration.

    ``seq``: tokens scored per pass. 1 is the paper's decode objective;
    seq = gamma + 1 prices a speculative *verify* pass, where FLOPs / KV
    copies / KV reads scale with seq but weight streaming (memory AND
    disk) is paid once per pass — the batched-verify amortization.
    """
    W = sum(w)
    if W == 0:
        return math.inf
    L = model.n_layers
    k = L / W
    tab = _coeff_table(devices, model)
    wv = np.asarray(w, dtype=float)
    nv = np.asarray(n, dtype=float)
    if cases is None:
        codes = classify_cases(devices, model, w, n, max(int(round(k)), 1))
    else:
        codes = np.asarray(cases, dtype=int)

    alpha = seq * tab.cpu_seq + tab.cpu_fix
    beta = tab.has_gpu * (seq * tab.gpu_seq + tab.gpu_fix - alpha)

    m1 = codes == int(Case.M1)
    m2 = codes == int(Case.M2)
    m3 = codes == int(Case.M3)
    a = alpha + (m1 | m3) * tab.bprime_disk + m2 * tab.lb_disk
    b = beta * ~m1 - m3 * tab.bprime_disk
    kappa = float(m1 @ tab.kappa_m1 + m3 @ tab.kappa_m3)

    # head-device constants (output layer on device 1's CPU)
    kappa += seq * tab.head_out_flops + tab.head_fixed
    if codes[0] != int(Case.M4):
        kappa += tab.head_out_disk

    lin = float(a @ wv + b @ nv) + tab.xi_sum
    return L / W * lin + kappa


def expected_tokens_per_cycle(acceptance: float, gamma: int) -> float:
    """E[tokens emitted per draft/verify cycle] at per-draft acceptance
    rate a: sum_{j<g} (j+1) a^j (1-a) + (g+1) a^g = (1 - a^{g+1})/(1 - a).
    """
    if acceptance >= 1.0:
        return gamma + 1.0
    if acceptance <= 0.0:
        return 1.0
    return (1.0 - acceptance ** (gamma + 1)) / (1.0 - acceptance)


@dataclasses.dataclass(frozen=True)
class SpecEstimate:
    """Acceptance-aware speculative throughput estimate."""

    tps: float                   # expected tokens/s
    tpot: float                  # expected seconds/token (1 / tps)
    cycle_latency: float         # draft + verify seconds per cycle
    verify_latency: float        # the multi-token target pass alone
    draft_latency: float         # the gamma+1 draft decodes per cycle
    tokens_per_cycle: float      # E[emitted]
    speedup: float               # vs the vanilla one-token decode loop


def speculative_estimate(devices: Sequence[DeviceProfile],
                         model: ModelProfile, w: Sequence[int],
                         n: Sequence[int], *, gamma: int,
                         acceptance: float,
                         draft_token_latency: float,
                         cases: Optional[Sequence[Case]] = None
                         ) -> SpecEstimate:
    """TPOT/TPS model for speculative decoding on an assignment.

    ``draft_token_latency``: one draft-model decode step (the draft runs
    resident on the head device; gamma + 1 steps per cycle — gamma
    proposals plus the KV-banking step, see ``runtime.speculative``).
    Halda assignments can be compared with and without speculation by
    evaluating this against ``token_latency`` for candidate (w, n).
    """
    t_vanilla = token_latency(devices, model, w, n, cases)
    t_verify = token_latency(devices, model, w, n, cases, seq=gamma + 1)
    t_draft = (gamma + 1) * draft_token_latency
    e = expected_tokens_per_cycle(acceptance, gamma)
    t_cycle = t_verify + t_draft
    tps = e / t_cycle
    return SpecEstimate(tps=tps, tpot=t_cycle / e, cycle_latency=t_cycle,
                        verify_latency=t_verify, draft_latency=t_draft,
                        tokens_per_cycle=e,
                        speedup=tps * t_vanilla)


@dataclasses.dataclass(frozen=True)
class StreamingCheck:
    """Measured prefetch timeline vs the analytic disk term."""

    predicted_layer_s: float     # layer_bytes / disk_speed (model term)
    measured_layer_s: float      # median staged-read time per layer
    measured_bps: float          # aggregate staging throughput
    modeled_bps: float           # the profile's disk_speed()
    ratio: float                 # measured_layer_s / predicted_layer_s

    @property
    def consistent(self) -> bool:
        """Within an order of magnitude — the model is a scheduler input,
        not a cycle-accurate simulator; page cache and file-open overhead
        move absolute numbers while relative ordering survives."""
        return 0.1 <= self.ratio <= 10.0


def streaming_disk_term(dev: DeviceProfile, layer_bytes: float) -> float:
    """Seconds the latency model charges to stream one layer from disk —
    the per-layer unit inside the M1-M3 ``b'/s_disk`` objective terms."""
    return layer_bytes / dev.disk_speed()


def quantized_layer_bytes(layer_bytes: float, *, bits: int = 4,
                          group: int = 64, weight_bytes: float = 2.0,
                          scale_bytes: float = 2.0,
                          quant_fraction: float = 1.0) -> float:
    """Reduced per-layer byte count ``b`` after grouped weight quantization
    — the quantity the disk term prices for a quantized (v2) layer store.

    ``layer_bytes`` is the unquantized store's bytes/layer at
    ``weight_bytes`` per weight (2.0 = bf16); the quantized fraction of it
    shrinks to ``bits/8 + scale_bytes/group`` bytes per weight (packed
    values + one bf16 scale per group, matching ``QuantizedTensor.nbytes``
    and the paper's Q4K ~4.5 bits/weight accounting), while the rest
    (norms, biases — ``1 - quant_fraction``) streams at full width. For
    q4/group-64 over bf16 this is ~0.27x, which is why persisting packed
    int4 moves the dominant ``layer_bytes / s_disk`` roofline term ~4x.
    """
    per_weight = bits / 8.0 + scale_bytes / group
    quantized = layer_bytes * quant_fraction * per_weight / weight_bytes
    return quantized + layer_bytes * (1.0 - quant_fraction)


# ---------------------------------------------------------------------------
# Paged KV-cache byte terms (runtime.kvcache)
# ---------------------------------------------------------------------------
#
# The dense cache's footprint is an envelope — batch * max_len — while the
# paged cache's tracks *live* tokens plus one partially-filled page per
# sequence. These terms price both so the scheduler (and the benchmark
# gates) can reason about KV growth and cold-page offload traffic the
# same way the streaming terms price weight movement.

def kv_bytes_per_token(model: ModelProfile) -> float:
    """KV bytes one decoded token adds across the whole stack — the paged
    cache's unit of allocation pressure (page_bytes = this * page_tokens).
    """
    return model.kv_bytes_per_token_layer * model.n_layers


def dense_kv_bytes(model: ModelProfile, batch: int, max_len: int) -> float:
    """Footprint of the dense (L, B, max_len, ...) preallocation."""
    return kv_bytes_per_token(model) * batch * max_len


def paged_kv_highwater(model: ModelProfile, active_tokens: int,
                       batch: int, page_tokens: int) -> float:
    """Upper bound on paged-cache HBM at ``active_tokens`` live tokens:
    every live token is paged, plus at most one partially-filled page per
    sequence (internal fragmentation is bounded by the page size)."""
    pages = -(-active_tokens // max(page_tokens, 1)) + batch
    return pages * kv_bytes_per_token(model) * page_tokens


@dataclasses.dataclass(frozen=True)
class PagedKVEstimate:
    """Analytic view of a paged-KV configuration (benchmark cross-checks)."""

    bytes_per_token: float       # per-token KV growth, whole stack
    page_bytes: float
    highwater_bytes: float       # paged bound at the active token count
    dense_bytes: float           # the batch * max_len envelope
    fetch_s_per_page: float      # host->device cold-page fetch term

    @property
    def savings(self) -> float:
        return self.dense_bytes / max(self.highwater_bytes, 1e-12)


def paged_kv_estimate(model: ModelProfile, *, active_tokens: int,
                      batch: int, max_len: int, page_tokens: int,
                      dev: Optional[DeviceProfile] = None
                      ) -> PagedKVEstimate:
    """Price a paged-KV configuration: per-token growth, high-water bound
    vs the dense envelope, and the cold-page fetch term (host offload
    moves page_bytes over the host memory bus, the analogue of the
    ``layer_bytes / s_disk`` weight-streaming term)."""
    bpt = kv_bytes_per_token(model)
    page_bytes = bpt * page_tokens
    bw = dev.cpu_membw if dev is not None else 10e9
    return PagedKVEstimate(
        bytes_per_token=bpt, page_bytes=page_bytes,
        highwater_bytes=paged_kv_highwater(model, active_tokens, batch,
                                           page_tokens),
        dense_bytes=dense_kv_bytes(model, batch, max_len),
        fetch_s_per_page=page_bytes / max(bw, 1.0))


def kv_offload_crosscheck(page_bytes: float, bw: float,
                          events: Sequence) -> StreamingCheck:
    """Cross-check the cold-page fetch term against the offloader's
    measured staging timeline (``runtime.kvcache.BlockOffloader.events``)
    — same closed loop as ``streaming_crosscheck``, with the host memory
    bus in place of the disk."""
    predicted = page_bytes / max(bw, 1.0)
    measured = median_event_duration(events)
    return StreamingCheck(
        predicted_layer_s=predicted, measured_layer_s=measured,
        measured_bps=aggregate_bps(events), modeled_bps=bw,
        ratio=measured / max(predicted, 1e-12))


@dataclasses.dataclass(frozen=True)
class TierRecallCosts:
    """Modeled seconds to recall one KV page into the device tier from
    each rung of the memory hierarchy — the pricing the tiered memory
    manager's cost-model eviction minimizes (expected recall loss =
    hit frequency x the victim's recall cost), in place of plain LRU.

    The terms are the same profiled quantities Halda's objective prices:
    a host recall moves ``page_bytes`` over the host memory bus
    (``cpu_membw``), a disk recall first reads the page file
    (``disk_speed``) and then still pays the host->device hop. Device is
    zero — the page is already where compute needs it.
    """

    page_bytes: float
    device_s: float = 0.0
    host_s: float = 0.0
    disk_s: float = 0.0

    def cost(self, tier: str) -> float:
        return {"device": self.device_s, "host": self.host_s,
                "disk": self.disk_s}[tier]


def kv_recall_costs(page_bytes: float, *,
                    dev: Optional[DeviceProfile] = None,
                    membw: Optional[float] = None,
                    disk_bps: Optional[float] = None) -> TierRecallCosts:
    """Price per-tier KV page recall from a device profile (or explicit
    bandwidths; defaults are a commodity host bus and SSD)."""
    bw = membw if membw is not None else (
        dev.cpu_membw if dev is not None else 10e9)
    dbps = disk_bps if disk_bps is not None else (
        dev.disk_speed() if dev is not None else 500e6)
    host_s = page_bytes / max(bw, 1.0)
    return TierRecallCosts(
        page_bytes=page_bytes, device_s=0.0, host_s=host_s,
        disk_s=page_bytes / max(dbps, 1.0) + host_s)


def tier_recall_crosscheck(costs: TierRecallCosts, tier: str,
                           events: Sequence) -> StreamingCheck:
    """Cross-check a tier's modeled recall term against the measured
    fetch timeline of that tier (``BlockOffloader.events`` for host
    recalls, the disk store's read events for disk recalls) — the same
    closed loop ``streaming_crosscheck`` runs on the weight path, so a
    recall-cost table that drifts from observed stalls is detectable
    instead of silently mis-evicting."""
    predicted = max(costs.cost(tier), 1e-12)
    measured = median_event_duration(events)
    return StreamingCheck(
        predicted_layer_s=predicted, measured_layer_s=measured,
        measured_bps=aggregate_bps(events),
        modeled_bps=costs.page_bytes / predicted,
        ratio=measured / predicted)


def median_event_duration(events: Sequence) -> float:
    """Median duration of a prefetch timeline (single definition, shared
    with ``runtime.streaming.PrefetchStats``). Zero-byte events (ring
    padding rows) are excluded."""
    durs = sorted(e.duration for e in events if e.nbytes > 0)
    return durs[len(durs) // 2] if durs else 0.0


def aggregate_bps(events: Sequence) -> float:
    """Aggregate staging throughput of a prefetch timeline."""
    nbytes = sum(e.nbytes for e in events)
    span = sum(e.duration for e in events)
    return nbytes / max(span, 1e-12)


def streaming_crosscheck(dev: DeviceProfile, layer_bytes: float,
                         events: Sequence) -> StreamingCheck:
    """Cross-check the analytic disk terms against a measured prefetch
    timeline (``runtime.streaming.PrefetchEvent`` list: each event is one
    background layer read into staging).

    This closes the loop the paper's profiler opens: the same quantity —
    seconds per streamed layer — exists both as a model coefficient
    (``layer_bytes / disk_speed``) and as a measurement (the prefetcher's
    per-layer read durations), so a profile whose disk numbers drift from
    reality is detectable rather than silently mis-scheduling.
    """
    predicted = streaming_disk_term(dev, layer_bytes)
    measured = median_event_duration(events)
    measured_bps = aggregate_bps(events)
    return StreamingCheck(
        predicted_layer_s=predicted, measured_layer_s=measured,
        measured_bps=measured_bps, modeled_bps=dev.disk_speed(),
        ratio=measured / max(predicted, 1e-12))


@dataclasses.dataclass(frozen=True)
class TermDrift:
    """One latency-model term vs its observed per-token counterpart."""

    term: str            # "disk" | "compute" | "comms"
    modeled_s: float     # seconds/token the Halda model charges
    measured_s: float    # seconds/token observed by the tracer

    @property
    def ratio(self) -> float:
        return self.measured_s / max(self.modeled_s, 1e-12)

    @property
    def consistent(self) -> bool:
        """Same order-of-magnitude budget as :class:`StreamingCheck` —
        the model is a scheduler input, not a simulator."""
        return 0.1 <= self.ratio <= 10.0


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Modeled-vs-measured drift across the latency model's terms.

    This is the signal an online Halda re-solve consumes (ROADMAP
    item 4): when a term's observed cost drifts outside its consistency
    band, the profile coefficient it came from no longer describes the
    hardware and the placement deserves a re-plan.
    """

    terms: Tuple[TermDrift, ...]
    tokens: int                    # token steps the measurement averages

    def term(self, name: str) -> Optional[TermDrift]:
        for t in self.terms:
            if t.term == name:
                return t
        return None

    @property
    def drifted(self) -> Tuple[str, ...]:
        return tuple(t.term for t in self.terms if not t.consistent)

    @property
    def consistent(self) -> bool:
        return not self.drifted

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {t.term: {"modeled_s": t.modeled_s,
                         "measured_s": t.measured_s,
                         "ratio": t.ratio,
                         "consistent": t.consistent}
                for t in self.terms}

    def report(self) -> str:
        lines = [f"drift report over {self.tokens} token(s):"]
        for t in self.terms:
            flag = "ok" if t.consistent else "DRIFT"
            lines.append(
                f"  {t.term:8s} modeled {t.modeled_s * 1e3:8.3f} ms/tok  "
                f"measured {t.measured_s * 1e3:8.3f} ms/tok  "
                f"ratio {t.ratio:6.2f}  [{flag}]")
        return "\n".join(lines)


def telemetry_crosscheck(dev: DeviceProfile, layer_bytes: float,
                         n_layers: int, *, stalls: Sequence = (),
                         prefetch_events: Sequence = (),
                         model: Optional[ModelProfile] = None,
                         n_hops: int = 0) -> DriftReport:
    """Compare a traced run's per-token splits against the model's terms.

    The unified tracer (``runtime.telemetry``) measures where each
    token's milliseconds actually went; the Halda objective *predicts*
    them from profile coefficients. This closes the loop per term:

      * **disk** — modeled ``n_layers * layer_bytes / disk_speed`` per
        streamed pass vs the prefetch timeline's total read time per
        token (``prefetch_events``; background reads, so overlap does
        not hide them the way exposed ``disk_wait`` would).
      * **compute** — ``device_coeffs(dev, model).alpha * n_layers``
        vs the mean ``compute`` split of the stall records (needs
        ``model``; skipped otherwise).
      * **comms** — ``dev.t_comm * n_hops`` vs the mean ``comms`` split
        (skipped when ``n_hops`` is 0).

    ``stalls`` is a sequence of ``runtime.telemetry.StallRecord``;
    ``prefetch_events`` a ``PrefetchEvent`` timeline. Terms without
    both a model value and a measurement are omitted rather than
    reported as spuriously drifted.
    """
    stalls = list(stalls)
    tokens = max(len(stalls), 1)
    terms: List[TermDrift] = []

    if prefetch_events:
        modeled_disk = n_layers * streaming_disk_term(dev, layer_bytes)
        measured_disk = sum(e.duration for e in prefetch_events
                            if e.nbytes > 0) / tokens
        terms.append(TermDrift("disk", modeled_disk, measured_disk))

    if model is not None and stalls:
        alpha = device_coeffs(dev, model).alpha
        measured_comp = sum(s.compute_s for s in stalls) / tokens
        terms.append(TermDrift("compute", alpha * n_layers,
                               measured_comp))

    if n_hops > 0 and stalls:
        measured_comms = sum(s.comms_s for s in stalls) / tokens
        terms.append(TermDrift("comms", dev.t_comm * n_hops,
                               measured_comms))

    return DriftReport(terms=tuple(terms), tokens=len(stalls))


def ttft(devices: Sequence[DeviceProfile], model: ModelProfile,
         w: Sequence[int], n: Sequence[int], prompt_len: int = 16) -> float:
    """Time-to-first-token: prefill modelled as one pass whose compute and
    KV-write terms scale with the prompt length while weight/disk terms are
    paid once (mmap'd weights are read once for the whole prompt batch).
    Vectorized over devices like ``token_latency``."""
    W = sum(w)
    if W == 0:
        return math.inf
    L = model.n_layers
    tab = _coeff_table(devices, model)
    codes = classify_cases(devices, model, w, n, max(int(round(L / W)), 1))
    wv = np.asarray(w, dtype=float)
    nv = np.asarray(n, dtype=float)
    l_m = L / W * wv
    l_gpu = L / W * nv
    total = float(np.sum(
        (l_m - l_gpu) * tab.cpu_flops_t * prompt_len
        + l_gpu * tab.gpu_flops_t * prompt_len
        + l_m * model.kv_bytes_per_token_layer * prompt_len / tab.membw
        + np.where(codes != int(Case.M4),
                   (l_m - l_gpu) * model.layer_bytes / tab.disk, 0.0)
        + L / W * tab.xi))
    return total + tab.head_out_flops


def chunked_prefill_ttft(devices: Sequence[DeviceProfile],
                         model: ModelProfile, w: Sequence[int],
                         n: Sequence[int], prompt_len: int = 16, *,
                         chunk: int = 0,
                         decode_step_s: Optional[float] = None) -> float:
    """TTFT under chunked paged admission.

    The prompt runs in ``ceil(prompt_len / chunk)`` page-aligned chunks
    computed straight into the block pool; between chunks the engine
    gives the active decode slots one step, so the admitted request's
    first token waits for the whole prompt's compute (same total FLOPs
    and KV writes as one-shot prefill — ``ttft``'s linear terms are
    length-additive) PLUS, per extra chunk, one re-paid per-pass overhead
    (the ``xi`` window term) and one interleaved decode step:

        TTFT_chunked = TTFT(prompt) + (chunks-1) * (L/W * xi + t_step)

    ``decode_step_s`` overrides the modeled decode step with a measured
    one (the serving benchmark feeds its observed p50 TPOT); the
    interleave part, ``(chunks-1) * t_step``, is what the runtime's
    ``decode/interleave_stall_s`` counter measures from the other side —
    ``chunked_prefill_crosscheck`` turns the pair into a drift term.
    """
    base = ttft(devices, model, w, n, prompt_len)
    if chunk <= 0 or chunk >= prompt_len or not math.isfinite(base):
        return base
    chunks = -(-prompt_len // chunk)
    tab = _coeff_table(devices, model)
    L, W = model.n_layers, sum(w)
    step = decode_step_s if decode_step_s is not None \
        else token_latency(devices, model, w, n)
    return base + (chunks - 1) * (L / W * tab.xi_sum + step)


def chunked_prefill_crosscheck(modeled_step_s: float,
                               measured_stall_s: float,
                               chunks: int) -> TermDrift:
    """Drift term for the chunked-admission interleave overhead.

    ``modeled_step_s`` is the decode step the TTFT term charges per extra
    chunk; ``measured_stall_s`` the runtime's total
    ``decode/interleave_stall_s`` for the admit. Both sides are divided
    by the interleave count so the drift ratio compares per-step costs
    (same convention as the per-token terms in ``telemetry_crosscheck``),
    and the result slots into a :class:`DriftReport` alongside them.
    """
    n = max(chunks - 1, 1)
    return TermDrift("interleave", modeled_step_s,
                     measured_stall_s / n)
