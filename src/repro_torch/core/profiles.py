"""Device and model profiles — the inputs to the LDA problem.

A copy of ``repro.core.profiles`` (pure Python, no JAX), so the port's
Halda, elastic re-plan and cluster selection give the JAX package's
results. ``tpu_stage_cluster`` is that package's TPU-stage profile,
kept for equal results; its figures are a TPU's, not the port's card's
(an H100 ``DeviceProfile`` measured by the port's profiler is ROADMAP
Queue A item 5).

Mirrors the paper's device profiler (Appendix A.3): per-device compute
throughput per quant format, memory-access throughput, disk read speed,
communication latency, OS/memory-management behaviour; and the model
profiler: per-layer FLOPs per quant format, per-layer weight bytes,
KV-cache geometry.

All quantities are SI (bytes, seconds, FLOP/s, bytes/s).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional

GiB = float(1 << 30)
MiB = float(1 << 20)


class OS(str, enum.Enum):
    MACOS = "macos"
    LINUX = "linux"
    ANDROID = "android"
    # TPU adaptation: a pipeline *stage* with explicit host->HBM streaming.
    # Reclaim behaviour is "explicit": the runtime owns eviction, which the
    # latency model treats like Linux sequential reload (Case 3/4 family).
    TPU_STAGE = "tpu_stage"


class Case(enum.IntEnum):
    """The paper's device cases M1..M4 (Section 3.2)."""

    M1 = 1  # macOS, Metal disabled, insufficient RAM, fast disk
    M2 = 2  # macOS, Metal enabled, insufficient RAM, fast disk
    M3 = 3  # Linux/Android (and TPU stage), insufficient RAM, fast disk
    M4 = 4  # sufficient RAM or slow disk -> no overload permitted


#: Quant formats considered by the profiler (paper: Q = {Q4K,...,F32}).
QUANTS = ("q4k", "q5k", "q6k", "q80", "f16", "f32")


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One ring participant.

    On the home cluster this is a physical device; on the TPU production mesh
    it is one pipeline stage (a TP group of chips) whose "disk" is host DRAM
    reached over DMA and whose "VRAM" is the per-stage HBM budget.
    """

    name: str
    os: OS = OS.LINUX
    # --- memory ---------------------------------------------------------
    ram_avail: float = 8 * GiB          # d_m^avail
    vram_avail: float = 0.0             # d_{m,cuda}^avail / d_{m,metal}^avail
    swap_avail: float = 0.0             # d_m^swap_avail (Android)
    bytes_can_swap: float = 0.0         # d_m^bytes_can_swap (Android)
    has_metal: bool = False
    has_cuda: bool = False
    uma: bool = False                   # unified memory (Apple M-series)
    # --- compute: FLOP/s per backend per quant --------------------------
    cpu_flops: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {q: 50e9 for q in QUANTS})
    gpu_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    # --- memory access --------------------------------------------------
    cpu_membw: float = 20e9             # T_m^cpu (bytes/s into registers)
    gpu_membw: float = 0.0              # T_m^cuda or T_m^metal
    t_kv_copy_cpu: float = 2e-6         # t_m^{kv_cpy,cpu} per layer per token
    t_kv_copy_gpu: float = 0.0
    t_ram_vram: float = 30e-6           # t_m^{ram->vram} per window
    t_vram_ram: float = 30e-6           # t_m^{vram->ram} per window
    # --- disk (or host DRAM for TPU stages) ------------------------------
    disk_seq_bps: float = 2.0e9         # sequential read (Linux mmap)
    disk_rand_bps: float = 1.0e9        # random read (macOS)
    # --- network ---------------------------------------------------------
    t_comm: float = 2e-3                # t_m^comm: one 4e-byte hop to successor

    @property
    def has_gpu(self) -> bool:
        return self.has_cuda or self.has_metal

    def disk_speed(self) -> float:
        """Effective mmap reload throughput for this OS (paper A.3)."""
        if self.os == OS.MACOS:
            return self.disk_rand_bps
        return self.disk_seq_bps

    def gpu_budget(self) -> float:
        """VRAM (CUDA) or recommended Metal working-set budget."""
        return self.vram_avail if self.has_gpu else 0.0

    def memory_budget(self) -> float:
        """Initialization budget used by Halda line 1."""
        if self.os == OS.MACOS and self.has_metal:
            return self.vram_avail  # d_{m,metal}^avail (UMA shared pool)
        if self.os == OS.ANDROID:
            return self.ram_avail + min(self.bytes_can_swap, self.swap_avail)
        return self.ram_avail + (self.vram_avail if self.has_cuda else 0.0)


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Model-side inputs to the latency model (paper's model profiler)."""

    name: str
    n_layers: int                        # L
    layer_bytes: float                   # b  (per decoder layer, all quants)
    input_bytes: float                   # b_i (embedding table)
    output_bytes: float                  # b_o (lm head)
    embed_dim: int                       # e
    vocab: int                           # V
    kv_heads: int                        # h_k = h_v
    head_dim: int                        # e_k = e_v
    n_kv: int = 1024                     # tokens resident in KV cache
    # FLOPs per *token* per layer, per quant format present in the file.
    flops_layer: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops_output: Dict[str, float] = dataclasses.field(default_factory=dict)
    c_cpu: float = 256 * MiB             # compute buffer (CPU side)
    c_gpu: float = 256 * MiB             # compute buffer (GPU side)
    # Per-layer recurrent-state bytes (SSM/RG-LRU archs); replaces KV bytes
    # for layers that carry O(1) state instead of a KV cache.
    state_bytes: float = 0.0

    @property
    def kv_bytes_per_token_layer(self) -> float:
        """2 * (h_k e_k + h_v e_v) in F16 -> bytes per layer per token."""
        return 2.0 * 2.0 * (self.kv_heads * self.head_dim)

    @property
    def kv_bytes_layer(self) -> float:
        """KV bytes per layer at context n_kv, plus any recurrent state."""
        return self.kv_bytes_per_token_layer * self.n_kv + self.state_bytes

    @property
    def b_prime(self) -> float:
        """b' = b + 2(h_k e_k + h_v e_v) n_kv (weights + KV per layer)."""
        return self.layer_bytes + self.kv_bytes_layer

    def head_extra_bytes(self) -> float:
        """(b_i / V + b_o): embedding row + lm-head bytes on the head device."""
        return self.input_bytes / self.vocab + self.output_bytes


def divisors(n: int, exclude_self: bool = True) -> List[int]:
    """Valid round counts K_L: divisors of L (paper excludes k = L)."""
    out = [d for d in range(1, n + 1) if n % d == 0]
    if exclude_self and len(out) > 1:
        out = [d for d in out if d != n]
    return out


# ---------------------------------------------------------------------------
# Model profile construction from an architecture config (decode FLOPs).
# ---------------------------------------------------------------------------

def profile_from_config(cfg, *, n_kv: int = 1024, quant: str = "q4k",
                        name: Optional[str] = None) -> ModelProfile:
    """Build a ModelProfile from a ``configs`` ModelConfig.

    FLOPs are per decoded token (batch 1): 2 * weight-params matmul FLOPs
    plus attention score/value FLOPs against the n_kv-token cache.
    Weight bytes honour the quant format (q4k ~ 4.5 bits/weight incl scales).
    """
    # q4k uses the Q4_K_M effective rate (~4.85 bits/weight: llama.cpp
    # mixes q4_K and q6_K blocks), matching the paper's 40 GiB for 70B.
    bits = {"q4k": 4.85, "q5k": 5.5, "q6k": 6.5, "q80": 8.5,
            "f16": 16.0, "f32": 32.0}[quant]
    e = cfg.d_model
    # Per-layer weight parameter count (attention + mixer), from the config's
    # own accounting (handles MoE/MLA/SSM variants).
    p_layer = cfg.params_per_layer()
    p_active = cfg.active_params_per_layer()
    layer_bytes = p_layer * bits / 8.0
    input_bytes = cfg.vocab * e * bits / 8.0
    output_bytes = cfg.vocab * e * bits / 8.0
    flops_layer = 2.0 * p_active
    if cfg.kv_heads > 0:
        flops_layer += 4.0 * cfg.n_heads * cfg.head_dim * min(
            n_kv, cfg.attn_window or n_kv)
    flops_out = 2.0 * cfg.vocab * e
    state_bytes = 0.0
    if getattr(cfg, "ssm_state", 0):
        # Mamba-2 state: heads x head_dim x state, fp32.
        state_bytes = 4.0 * cfg.d_inner * cfg.ssm_state
    return ModelProfile(
        name=name or cfg.name,
        n_layers=cfg.n_layers,
        layer_bytes=layer_bytes,
        input_bytes=input_bytes,
        output_bytes=output_bytes,
        embed_dim=e,
        vocab=cfg.vocab,
        kv_heads=max(cfg.kv_heads, 0),
        head_dim=cfg.head_dim if cfg.kv_heads else 0,
        n_kv=min(n_kv, cfg.attn_window or n_kv) if cfg.kv_heads else 0,
        flops_layer={quant: flops_layer},
        flops_output={quant: flops_out},
        state_bytes=state_bytes,
    )


# ---------------------------------------------------------------------------
# Reference clusters
# ---------------------------------------------------------------------------

def paper_table2_cluster() -> List[DeviceProfile]:
    """The paper's Table 2 home cluster, D1-D4 (defaults for Table 3/4)."""
    return [
        DeviceProfile(
            name="D1-MacM1", os=OS.MACOS, has_metal=True, uma=True,
            ram_avail=2.4 * GiB, vram_avail=5.3 * GiB,  # Metal working set
            cpu_flops={q: 150e9 for q in QUANTS},
            gpu_flops={q: 500e9 for q in QUANTS},
            cpu_membw=60e9, gpu_membw=60e9,
            t_kv_copy_cpu=1e-6, t_kv_copy_gpu=1e-6,
            t_ram_vram=0.0, t_vram_ram=0.0,
            disk_seq_bps=0.72e9, disk_rand_bps=0.72e9, t_comm=2e-3),
        DeviceProfile(
            name="D2-Laptop3070", os=OS.LINUX, has_cuda=True,
            ram_avail=4.1 * GiB, vram_avail=8.0 * GiB,
            cpu_flops={q: 200e9 for q in QUANTS},
            gpu_flops={q: 2000e9 for q in QUANTS},
            cpu_membw=40e9, gpu_membw=400e9,
            t_kv_copy_cpu=1e-6, t_kv_copy_gpu=0.5e-6,
            t_ram_vram=20e-6, t_vram_ram=20e-6,
            disk_seq_bps=2.98e9, disk_rand_bps=1.5e9, t_comm=2e-3),
        DeviceProfile(
            name="D3-Desktop2080Ti", os=OS.LINUX, has_cuda=True,
            ram_avail=9.7 * GiB, vram_avail=11.0 * GiB,
            cpu_flops={q: 400e9 for q in QUANTS},
            gpu_flops={q: 2500e9 for q in QUANTS},
            cpu_membw=50e9, gpu_membw=500e9,
            t_kv_copy_cpu=1e-6, t_kv_copy_gpu=0.5e-6,
            t_ram_vram=20e-6, t_vram_ram=20e-6,
            disk_seq_bps=3.17e9, disk_rand_bps=1.6e9, t_comm=2e-3),
        DeviceProfile(
            name="D4-Mate40Pro", os=OS.ANDROID,
            ram_avail=1.9 * GiB, swap_avail=4.0 * GiB,
            bytes_can_swap=2.0 * GiB,
            cpu_flops={q: 80e9 for q in QUANTS},
            cpu_membw=25e9,
            t_kv_copy_cpu=2e-6,
            disk_seq_bps=1.37e9, disk_rand_bps=0.8e9, t_comm=2e-3),
    ]


def paper_table2_extra() -> List[DeviceProfile]:
    """D5 (Honor Pad) and D6 (Mac Air) from Table 2, for A.5 experiments."""
    return [
        DeviceProfile(
            name="D5-HonorPad", os=OS.ANDROID,
            ram_avail=5.1 * GiB, swap_avail=4.0 * GiB,
            bytes_can_swap=2.0 * GiB,
            cpu_flops={q: 100e9 for q in QUANTS},
            cpu_membw=25e9, t_kv_copy_cpu=2e-6,
            disk_seq_bps=2.0e9, disk_rand_bps=1.0e9, t_comm=2e-3),
        DeviceProfile(
            name="D6-MacAir", os=OS.MACOS, has_metal=False,
            ram_avail=6.8 * GiB,
            cpu_flops={q: 60e9 for q in QUANTS},
            cpu_membw=15e9, t_kv_copy_cpu=3e-6,
            disk_seq_bps=0.39e9, disk_rand_bps=0.39e9, t_comm=2e-3),
    ]


def tpu_stage_cluster(n_stages: int, *, hbm_budget: float = 14 * GiB,
                      chips_per_stage: int = 16,
                      peak_flops: float = 197e12,
                      hbm_bw: float = 819e9,
                      dma_bps: float = 40e9,
                      ici_latency: float = 1.5e-6) -> List[DeviceProfile]:
    """Homogeneous TPU pipeline stages (production-mesh adaptation).

    Each stage is ``chips_per_stage`` v5e chips in a TP group. "disk" is the
    host-DRAM DMA path used for streamed (offloaded) layer windows. ``cuda``
    semantics model "HBM-resident layers are pinned" (no reload), matching
    the CUDA-driver-locked VRAM behaviour in the paper.
    """
    stage_flops = peak_flops * chips_per_stage
    return [
        DeviceProfile(
            name=f"stage{i}", os=OS.TPU_STAGE, has_cuda=True,
            ram_avail=hbm_budget * 0.25,     # streaming buffer share of HBM
            vram_avail=hbm_budget * chips_per_stage,
            cpu_flops={q: stage_flops * 0.1 for q in QUANTS},  # streamed path
            gpu_flops={q: stage_flops for q in QUANTS},
            cpu_membw=dma_bps, gpu_membw=hbm_bw * chips_per_stage,
            t_kv_copy_cpu=0.2e-6, t_kv_copy_gpu=0.05e-6,
            t_ram_vram=2e-6, t_vram_ram=2e-6,
            disk_seq_bps=dma_bps, disk_rand_bps=dma_bps,
            t_comm=ici_latency)
        for i in range(n_stages)
    ]
