"""Device profiler of the port: measures the quantities the Halda latency
model consumes (paper Appendix A.3's "device profiler"), on the card and
on its host.

The counterpart of ``repro.core.profiler``. The compute, memory and KV
probes are torch probes on an explicit device: a matmul, a streaming copy
and a one-line cache write, timed with CUDA events on the card and with
the host clock on the CPU (they probe the device; they port no kernel, so
``torch.matmul`` is what they should time). The disk probes are the JAX
package's, copied (numpy and the filesystem). Every probe reports the
median of repeated runs after a warm-up, so a profile is stable enough to
feed the scheduler; re-running the profiler and re-solving is the elastic
path (the paper's limitation (d)).

``profile_local_device`` returns the ``DeviceProfile`` of the machine: on
the card (the default) a CUDA device with its free memory as the VRAM
budget, its matmul rate and memory rate as the GPU terms and the host's
as the CPU terms; with ``device="cpu"`` the host alone, as the JAX
package's profile of a machine without an accelerator.
"""
from __future__ import annotations

import mmap
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from .profiles import GiB, OS, QUANTS, DeviceProfile


def _median_time(fn: Callable[[], None], *, warmup: int = 1,
                 iters: int = 5) -> float:
    """Median wall seconds of ``fn`` on the host clock."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    out.sort()
    return out[len(out) // 2]


def _device_time(fn: Callable[[], None], device: torch.device, *,
                 warmup: int = 2, iters: int = 9) -> float:
    """Median seconds of ``fn`` on ``device``: between CUDA events on the
    card (the device's own clock), on the host clock elsewhere."""
    if device.type != "cuda":
        return _median_time(fn, warmup=warmup, iters=iters)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 1e3)
    out.sort()
    return out[len(out) // 2]


def measure_flops(n: int = 1024, dtype=torch.float32,
                  device="cuda") -> float:
    """Matmul FLOP/s of an (n, n) x (n, n) product on ``device``."""
    device = torch.device(device)
    a = torch.ones((n, n), dtype=dtype, device=device)
    b = torch.ones((n, n), dtype=dtype, device=device)
    out = torch.empty((n, n), dtype=dtype, device=device)
    dt = _device_time(lambda: torch.matmul(a, b, out=out), device)
    return 2.0 * n ** 3 / dt


def measure_membw(nbytes: int = 1 << 26, device="cuda") -> float:
    """Bytes/s of a streaming read and write (an f32 scale) of ``nbytes``
    on ``device``."""
    device = torch.device(device)
    x = torch.ones((nbytes // 4,), dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    dt = _device_time(lambda: torch.mul(x, 1.0000001, out=y), device)
    return 2.0 * nbytes / dt


def measure_kv_copy(kv_bytes: int = 4096, device="cuda") -> float:
    """Seconds to write one token's KV line (``kv_bytes`` of bf16) into a
    1024-line cache buffer on ``device``."""
    device = torch.device(device)
    cache = torch.zeros((1024, kv_bytes // 2), dtype=torch.bfloat16,
                        device=device)
    line = torch.ones((1, kv_bytes // 2), dtype=torch.bfloat16,
                      device=device)
    return _device_time(lambda: cache[3:4].copy_(line), device)


def measure_disk(nbytes: int = 64 << 20, path: Optional[str] = None
                 ) -> float:
    """Sequential read bytes/s through the filesystem (page cache dropped
    is not possible unprivileged — this measures the warm path, an upper
    bound; the scheduler cares about relative ordering)."""
    fd, tmp = tempfile.mkstemp(dir=path)
    try:
        blob = np.random.default_rng(0).bytes(nbytes)
        with os.fdopen(fd, "wb") as f:
            f.write(blob)

        def read():
            with open(tmp, "rb") as f:
                while f.read(8 << 20):
                    pass

        dt = _median_time(read, warmup=1, iters=3)
        return nbytes / dt
    finally:
        os.unlink(tmp)


def measure_disk_random(nbytes: int = 32 << 20, block: int = 1 << 20,
                        path: Optional[str] = None, seed: int = 0) -> float:
    """Random-offset read bytes/s (the macOS-style mmap reload pattern,
    ``DeviceProfile.disk_rand_bps``). Reads ``block``-sized chunks at
    shuffled offsets of a fresh file."""
    fd, tmp = tempfile.mkstemp(dir=path)
    try:
        blob = np.random.default_rng(seed).bytes(nbytes)
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        offsets = np.arange(0, nbytes, block)
        np.random.default_rng(seed + 1).shuffle(offsets)

        def read():
            with open(tmp, "rb") as f:
                for off in offsets:
                    f.seek(int(off))
                    f.read(block)

        dt = _median_time(read, warmup=1, iters=3)
        return nbytes / dt
    finally:
        os.unlink(tmp)


def measure_stream_read(layer_nbytes: int = 8 << 20, n_layers: int = 4,
                        path: Optional[str] = None) -> float:
    """Bytes/s of the weight-streaming access pattern itself: per-layer
    flat files read end to end through mmap with a private staging copy,
    as ``runtime.streaming.LayerPrefetcher`` reads a layer. This is the
    probe the streaming disk terms of ``core.latency`` should be fed from
    (``measure_disk`` reads one big file; the layer-sharded store pays
    per-file open and fault overhead too)."""
    d = tempfile.mkdtemp(dir=path)
    files = []
    try:
        blob = np.random.default_rng(0).bytes(layer_nbytes)
        for i in range(n_layers):
            p = os.path.join(d, f"layer_{i:05d}.bin")
            with open(p, "wb") as f:
                f.write(blob)
            files.append(p)

        def read():
            for p in files:
                with open(p, "rb") as f:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                    np.array(np.frombuffer(mm, dtype=np.uint8), copy=True)
                    mm.close()

        dt = _median_time(read, warmup=1, iters=3)
        return n_layers * layer_nbytes / dt
    finally:
        for p in files:
            os.unlink(p)
        os.rmdir(d)


def host_ram_available() -> float:
    """Bytes of host memory available (psutil's figure where it is
    installed, else the free pages the OS reports)."""
    try:
        import psutil
        return float(psutil.virtual_memory().available)
    except Exception:
        try:
            return float(os.sysconf("SC_AVPHYS_PAGES")
                         * os.sysconf("SC_PAGE_SIZE"))
        except (ValueError, OSError, AttributeError):
            return 8 * GiB


def profile_local_device(name: str = "local", *, quick: bool = True,
                         device="cuda", path: Optional[str] = None
                         ) -> DeviceProfile:
    """A ``DeviceProfile`` of this machine for the Halda scheduler.

    The host's terms (CPU matmul rate, memory rate, KV line copy, free RAM)
    are measured on the CPU; the disk terms through files in ``path`` (the
    temporary directory by default), the sequential figure bounded above
    by the layer-streaming pattern, as the JAX package's profiler does. On
    a CUDA ``device`` the card's terms come from the same probes there:
    f32 and bf16 matmul rates (bf16 stands for the q4/q8 weight types the
    card computes in), memory rate, KV line copy, and its free memory as
    the VRAM budget. ``quick`` takes small sizes."""
    device = torch.device(device)
    cpu = torch.device("cpu")
    flops = measure_flops(512 if quick else 2048, device=cpu)
    kw = dict(
        name=name, os=OS.LINUX, ram_avail=host_ram_available(),
        cpu_flops={q: flops for q in QUANTS},
        cpu_membw=measure_membw(1 << 24 if quick else 1 << 28, device=cpu),
        t_kv_copy_cpu=measure_kv_copy(device=cpu),
        disk_seq_bps=min(measure_disk(8 << 20 if quick else 256 << 20,
                                      path=path),
                         measure_stream_read(1 << 20 if quick else 16 << 20,
                                             n_layers=4, path=path)),
        disk_rand_bps=measure_disk_random(4 << 20 if quick else 64 << 20,
                                          path=path),
        t_comm=1e-4)
    if device.type == "cuda":
        n = 2048 if quick else 8192
        f32 = measure_flops(n, torch.float32, device)
        bf16 = measure_flops(n, torch.bfloat16, device)
        free, _ = torch.cuda.mem_get_info(device)
        kw.update(has_cuda=True, vram_avail=float(free),
                  gpu_flops={q: (f32 if q == "f32" else bf16)
                             for q in QUANTS},
                  gpu_membw=measure_membw(1 << 28 if quick else 1 << 30,
                                          device),
                  t_kv_copy_gpu=measure_kv_copy(device=device))
    return DeviceProfile(**kw)
