"""Async layer prefetcher and the streamed serve engine of the port
(``repro.runtime.streaming``'s layer-wise half, in PyTorch).

The paper's fix for the prefetch-release conflict, made explicit:

  * a background thread copies layer ``k + w`` out of the layer-sharded
    mmap store (``runtime.paramstore``) into private staging buffers while
    layer ``k`` computes — the kernel cannot reclaim a staging copy to
    satisfy the prefetch itself;
  * on the card, the staged bytes go host-to-device on a side CUDA stream,
    so the copy of the next layers overlaps compute on this one;
  * release is explicit and strictly behind the compute front: once the
    front passes layer ``k`` its buffers are freed and the store drops its
    mmap pages (``MADV_DONTNEED``), so the resident set is bounded by the
    window, never the model.

Staging on the card: one host memcpy per layer, from the mmap into a
pinned buffer of a ring of ``window + 1`` buffers of ``layer_nbytes``
pinned once (pinning 146 MB costs milliseconds, so never per layer); then
one host-to-device copy of the whole flat layer on the side stream, whose
event ``get`` makes the compute stream wait on. Leaves are views into the
flat device buffer at the manifest's offsets (a leaf whose offset is not
aligned to its element size is copied, on the same side stream). A served
layer's device memory is marked in use by the compute stream
(``record_stream``), so the allocator cannot hand it out again until the
compute stream has passed the work queued on it. Quantized (v2) stores
flow through unchanged: only the packed bytes are staged and copied.

With a ``telemetry.Tracer`` attached the prefetcher emits on the JAX
prefetcher's tracks: ``layer_read[i]`` spans (mmap to staging) and ``h2d``
spans on ``prefetcher``, ``disk_wait[i]`` phases on ``decode`` (the
compute front blocked in ``get``) and the ``store/released_bytes``
counter. The ``h2d`` span times the *enqueue* of a ``non_blocking`` copy
on the side stream, not the copy: the copy's own time is a device time,
which ``chip_smoke.py`` measures with CUDA events around ``_to_card``.

``RingBankPrefetcher`` and ``StreamingRingDriver`` (the streamed SPMD
ring) are not ported yet (ROADMAP Queue A item 7).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..quant.grouped import map_tree, tree_tensors
from .iopolicy import IOPolicy, StallTimeout, WorkerHealth
from .memory import TierManager
from .paramstore import ParamSource, ParamStore
from .telemetry import clock, resolve_tracer

Params = Dict[str, Any]

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class PrefetchEvent:
    """One background layer read (staging copy from the mmap store)."""

    layer: int
    t_start: float
    t_end: float
    nbytes: int

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    @property
    def bps(self) -> float:
        return self.nbytes / max(self.duration, 1e-12)


@dataclasses.dataclass
class PrefetchStats:
    """Aggregate view of a prefetcher run."""

    events: List[PrefetchEvent]
    peak_resident_bytes: int          # max staged parameter bytes
    total_bytes_read: int
    stall_s: float                    # compute blocked waiting on a layer
    layers_served: int
    releases: int
    retries: int = 0                  # transient I/O retries (IOPolicy)
    released_bytes: int = 0           # bytes the store returned to the OS
    budget_refusals: int = 0          # staging leases the budget refused

    @property
    def bytes_per_layer(self) -> float:
        """Measured streamed bytes per staged layer (the packed footprint
        for a quantized store)."""
        reads = [e for e in self.events if e.nbytes > 0]
        return (sum(e.nbytes for e in reads) / len(reads)) if reads else 0.0

    @property
    def median_layer_read_s(self) -> float:
        durs = [e.duration for e in self.events]
        return float(np.median(durs)) if durs else 0.0


class LayerPrefetcher:
    """Keep a cyclic window of ``window`` layers staged ahead of the front.

    ``get(i)`` blocks until layer ``i`` is staged, schedules reads through
    ``i + window - 1`` (mod L), and releases every staged layer behind the
    front (cyclic distance >= window). Access is expected in decode order,
    layers 0..L-1 repeated per pass, but any order is correct.

    ``window`` is a scheduling lookahead: every staged byte is leased from
    ``memory`` (a shared ``TierManager``, or a private unbounded one) —
    host bytes while staging, device bytes once copied to the card — so a
    full tier throttles the worker instead of overshooting.

    ``device_put=False`` or a CPU ``device`` keeps the staged tensors on
    the host (views of the staging ring), valid until their layer is
    released.
    """

    def __init__(self, store: ParamStore, *, window: int = 4,
                 device_put: bool = True, device="cuda",
                 policy: Optional[IOPolicy] = None, tracer=None,
                 memory: Optional[TierManager] = None):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.store = store
        self.window = min(window, store.n_layers)
        self.device = torch.device(device)
        self.on_card = device_put and self.device.type == "cuda"
        if self.on_card and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.policy = policy or IOPolicy()
        self.tracer = resolve_tracer(tracer)
        self.memory = memory if memory is not None \
            else TierManager(name="prefetch-memory")
        self.owner = "weights"
        self.health = WorkerHealth(name="LayerPrefetcher")
        self._side = torch.cuda.Stream(self.device) if self.on_card else None
        # the staging ring (allocated by the worker at its first read) and
        # its free buffers, each with the event of the last copy out of it
        self._free: deque = deque()
        self._ring_made = False
        # layer -> (tree, nbytes, tier at rest, host buffer | copy event)
        self._buf: Dict[int, Tuple[Params, int, str, Any]] = {}
        self._queue: deque = deque()
        self._inflight: set = set()
        self._cv = threading.Condition()
        self._stop = False
        self._interrupted = False
        self._error: Optional[BaseException] = None
        self._events: List[PrefetchEvent] = []
        self._resident = 0
        self._peak = 0
        self._read = 0
        self._stall = 0.0
        self._served = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- worker ------------------------------------------------------------ #

    def _reopen(self, i: int) -> None:
        reopen = getattr(self.store, "reopen", None)
        if reopen is not None:
            reopen(i)

    def _take_buffer(self) -> torch.Tensor:
        """A free staging buffer; once its last copy to the card is done."""
        with self._cv:
            if not self._ring_made:
                n = self.store.layer_nbytes
                for _ in range(self.window + 1):
                    self._free.append((torch.empty(
                        n, dtype=torch.uint8, pin_memory=self.on_card),
                        None))
                self._ring_made = True
            # window + 1 buffers: the in-window layers plus, at most, one
            # read that was in flight when the front moved past it
            while not self._free:
                if self._stop:
                    raise RuntimeError("prefetcher stopped")
                self._cv.wait(0.25)
            buf, event = self._free.popleft()
        if event is not None:
            event.synchronize()
        return buf

    def _give_back(self, buf: torch.Tensor, event=None) -> None:
        with self._cv:
            self._free.append((buf, event))
            self._cv.notify_all()

    def _stage(self, i: int) -> Tuple[torch.Tensor, float, float]:
        """Copy layer i out of the mmap into a staging buffer (one
        memcpy); returns (the buffer, t_start, t_end)."""
        self.store.willneed(i)
        t0 = clock()
        src = self.store.layer_bytes(i)
        buf = self._take_buffer()
        try:
            buf[:src.numel()].copy_(src)
        except BaseException:
            self._give_back(buf)
            raise
        return buf, t0, clock()          # event = disk -> staging only

    def _to_card(self, buf: torch.Tensor, nbytes: int):
        """Host-to-device copy of a staged layer on the side stream; the
        staging buffer goes back to the ring with the copy's event."""
        with torch.cuda.stream(self._side):
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dev.copy_(buf[:nbytes], non_blocking=True)
            tree = self.store.leaves(dev)    # unaligned leaves copy here
            event = torch.cuda.Event()
            event.record(self._side)
        self._give_back(buf, event)
        return tree, event

    def _fail(self, i: int, e: BaseException) -> None:
        with self._cv:
            self._error = e
            self._inflight.discard(i)
            self._cv.notify_all()

    def _worker(self) -> None:
        if self.on_card:
            torch.cuda.set_device(self.device)
        est = self.store.layer_nbytes     # upper bound on a staged layer
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                i = self._queue.popleft()
                self._inflight.add(i)
            # lease before materializing: live leases bound true residency
            try:
                self.memory.lease("host", est, self.owner, wait=True,
                                  timeout=self.policy.op_deadline_s,
                                  cancelled=lambda: self._stop)
            except BaseException as e:
                self._fail(i, e)
                return
            try:
                buf, t0, t1 = self.policy.run(
                    f"layer_read[{i}]", lambda: self._stage(i),
                    reopen=lambda: self._reopen(i), health=self.health)
            except (KeyboardInterrupt, SystemExit):
                # control flow, never a latched I/O error: unblock get()
                self.memory.release("host", est, self.owner)
                with self._cv:
                    self._stop = True
                    self._interrupted = True
                    self._inflight.discard(i)
                    self._cv.notify_all()
                raise
            except BaseException as e:   # surface in get(), don't deadlock
                self.memory.release("host", est, self.owner)
                self._fail(i, e)
                return
            nbytes = self.store.layer_nbytes
            self.memory.resize("host", self.owner, est, nbytes)
            tier, handle = "host", buf
            try:
                if self.on_card:
                    # lease device bytes, copy, then drop the host lease
                    try:
                        self.memory.lease("device", nbytes, self.owner,
                                          wait=True,
                                          timeout=self.policy.op_deadline_s,
                                          cancelled=lambda: self._stop)
                    except BaseException:
                        self._give_back(buf)
                        raise
                    try:
                        with self.tracer.span("h2d", cat="prefetch",
                                              track="prefetcher", layer=i):
                            staged, handle = self._to_card(buf, nbytes)
                    except BaseException:
                        self.memory.release("device", nbytes, self.owner)
                        raise
                    self.memory.release("host", nbytes, self.owner)
                    tier = "device"
                else:
                    staged = self.store.leaves(buf[:nbytes])
            except BaseException as e:
                self.memory.release("host", nbytes, self.owner)
                self._fail(i, e)
                return
            self.tracer.span_event(f"layer_read[{i}]", t0, t1,
                                   cat="prefetch", track="prefetcher",
                                   nbytes=nbytes)
            with self._cv:
                self._inflight.discard(i)
                if i not in self._buf and not self._stop:
                    self._buf[i] = (staged, nbytes, tier, handle)
                    self._resident += nbytes
                    self._peak = max(self._peak, self._resident)
                else:   # duplicate stage / raced close: hand bytes back
                    self._drop_locked(nbytes, tier, handle)
                self._read += nbytes
                self._events.append(PrefetchEvent(i, t0, t1, nbytes))
                self._cv.notify_all()

    # -- front side -------------------------------------------------------- #

    def _drop_locked(self, nbytes: int, tier: str, handle) -> None:
        self.memory.release(tier, nbytes, self.owner)
        if tier == "host":
            self._free.append((handle, None))

    def _schedule_locked(self, i: int) -> None:
        L = self.store.n_layers
        # reads queued for an earlier front and now outside the window
        # would only be released unread
        self._queue = deque(j for j in self._queue
                            if (j - i) % L < self.window)
        for d in range(self.window):
            j = (i + d) % L
            if j not in self._buf and j not in self._inflight \
                    and j not in self._queue:
                self._queue.append(j)
        self._cv.notify_all()

    def _release_locked(self, front: int) -> None:
        L = self.store.n_layers
        dropped = False
        for j in list(self._buf):
            if (j - front) % L >= self.window:
                _, nbytes, tier, handle = self._buf.pop(j)
                self._resident -= nbytes
                self._drop_locked(nbytes, tier, handle)
                self.store.release(j)
                dropped = True
        if dropped:
            self.tracer.counter(
                "store/released_bytes",
                getattr(self.store, "released_bytes", 0),
                track="prefetcher")
            self._cv.notify_all()

    def get(self, i: int, *, timeout: Optional[float] = None) -> Params:
        """Block until layer ``i`` is staged, at most ``timeout`` seconds
        (default: the policy's ``get_timeout_s``) — a wedged worker
        becomes a ``StallTimeout`` with a health report. On the card the
        current stream waits for the layer's copy before using it."""
        if timeout is None:
            timeout = self.policy.get_timeout_s
        deadline = clock() + timeout
        with self._cv:
            self._schedule_locked(i)
            self._release_locked(i)
            t0 = clock()
            with self.tracer.phase("disk_wait", cat="prefetch",
                                   track="decode", min_dur=2e-4,
                                   label=f"disk_wait[{i}]"):
                while i not in self._buf:
                    if self._error is not None:
                        raise RuntimeError(
                            f"prefetch of layer {i} failed "
                            f"({self.health.report()})") from self._error
                    if self._stop:
                        raise RuntimeError(
                            "prefetcher stopped" + (
                                " (worker interrupted)"
                                if self._interrupted else ""))
                    remaining = deadline - clock()
                    if remaining <= 0:
                        self.health.stalled = True
                        raise StallTimeout(
                            f"layer {i} not staged within {timeout:.1f}s "
                            f"({self.health.report()})",
                            op=f"layer_read[{i}]")
                    self._cv.wait(min(remaining, 0.25))
            self._stall += clock() - t0
            self._served += 1
            tree, _, tier, handle = self._buf[i]
        if tier == "device":
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(handle)
            for t in tree_tensors(tree):
                t.record_stream(stream)
        return tree

    def stats(self) -> PrefetchStats:
        with self._cv:
            refusals = sum(s.refusals
                           for s in self.memory.stats().values())
            return PrefetchStats(
                events=list(self._events), peak_resident_bytes=self._peak,
                total_bytes_read=self._read, stall_s=self._stall,
                layers_served=self._served, releases=self.store.released,
                retries=self.health.retries,
                released_bytes=getattr(self.store, "released_bytes", 0),
                budget_refusals=refusals)

    def close(self, timeout: float = 5.0) -> bool:
        """Stop the worker; returns True once it has joined. Idempotent.
        Staged buffers hand their leases back, so a shared budget
        balances after shutdown."""
        with self._cv:
            self._stop = True
            for j in list(self._buf):
                _, nbytes, tier, handle = self._buf.pop(j)
                self._resident -= nbytes
                self._drop_locked(nbytes, tier, handle)
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self.health.stalled = True
            log.error("LayerPrefetcher.close: worker failed to join "
                      "within %.1fs — %s", timeout, self.health.report())
            return False
        self.health.closed = True
        return True


class StreamingParamSource(ParamSource):
    """ParamSource over a store + async prefetcher (the streamed path).

    The head (embedding / final norm / lm head) is loaded once and stays
    resident, as the paper pins the head on the first device; block
    layers stream through the ``window``-sized prefetch buffer.
    """

    def __init__(self, store: ParamStore, *, window: int = 4,
                 device_put: bool = True, device="cuda",
                 policy: Optional[IOPolicy] = None, tracer=None,
                 memory: Optional[TierManager] = None):
        self.store = store
        self.n_layers = store.n_layers
        self.prefetcher = LayerPrefetcher(store, window=window,
                                          device_put=device_put,
                                          device=device, policy=policy,
                                          tracer=tracer, memory=memory)
        head = store.head()
        if self.prefetcher.on_card:
            head = map_tree(lambda t: t.to(self.prefetcher.device), head)
        self._head = head

    def layer(self, i: int) -> Params:
        return self.prefetcher.get(i)

    def head(self) -> Params:
        return self._head

    def stats(self) -> PrefetchStats:
        return self.prefetcher.stats()

    def close(self) -> None:
        self.prefetcher.close()
        self.store.close()

    def __enter__(self) -> "StreamingParamSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------------- #
#  continuous-batching integration
# --------------------------------------------------------------------------- #

def make_streaming_engine(source: ParamSource, cfg, batch: int, ctx: int,
                          *, eos_id: Optional[int] = None, spec=None,
                          cache_dtype=torch.float32, tracer=None,
                          metrics=None, graphs: bool = True, device="cuda"):
    """A ``ContinuousBatcher`` whose prefill and decode pull weights from
    ``source`` layer by layer (resident or streamed: the same engine),
    over a dense cache. Drive it with
    ``eng.run(init_cache(cfg, batch, ctx, cache_dtype, device), reqs)``.
    ``spec``: a ``SpeculativeDecoder`` whose verify is
    ``decode_step_layerwise`` over the same source at T = gamma + 1 (set
    ``spec.verify = eng.decode``), so each layer is read once for the
    whole draft block.

    ``graphs`` (the default): over a ``ResidentSource`` (every layer at
    a fixed address) the decode step is replayed from CUDA graphs
    (``engine.GraphedDecode``), one per T. A streamed source hands out
    layers in rotating device buffers, so its step stays eager.
    """
    from ..models import model as M
    from .engine import (ContinuousBatcher, GraphedDecode, StepGraphs,
                         dense_scrub, write_dense_slot)
    from .paramstore import ResidentSource

    def prefill_one(prompt):
        c1 = M.init_cache(cfg, 1, ctx, dtype=cache_dtype, device=device)
        logits, c1 = M.prefill_layerwise(source, cfg, prompt, c1)
        return int(torch.argmax(logits[0, -1])), c1

    def decode(cache, tokens):
        return M.decode_step_layerwise(source, cfg, cache, tokens)

    sg = None
    if graphs and isinstance(source, ResidentSource):
        sg = StepGraphs(device)
        decode = GraphedDecode(decode, sg, dense_scrub)
    return ContinuousBatcher(batch, prefill_one, write_dense_slot, decode,
                             eos_id=eos_id, spec=spec, source=source,
                             ctx=ctx, tracer=tracer, metrics=metrics,
                             device=device, graphs=sg)
