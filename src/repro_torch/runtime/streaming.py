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

``RingBankPrefetcher`` and ``StreamingRingDriver`` stream the piped ring
(``runtime.serve``) the same way: a worker stages each microstep's
window bank one step ahead of the compute front and releases a layer
after its last use in the pass. ``RankWindowPrefetcher`` streams one rank
of the ring across ranks: only its stage's windows, and of each row only
the rank's part of every leaf (``serve.RankRingStep`` runs them).
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


class _Staging:
    """The staging half shared by the prefetchers: a ring of
    ``_n_buffers`` staging buffers of ``layer_nbytes`` (pinned on the
    card, allocated at the first read), one memcpy of a layer out of the
    mmap into a free one (``_stage``), and its host-to-device copy on the
    side stream (``_to_card``), after which the buffer goes back to the
    ring with the copy's event. Subclasses set ``store``, ``on_card``,
    ``device``, ``_side``, ``_cv``, ``_free``, ``_ring_made``, ``_stop``,
    ``_n_buffers`` and ``_buf_nbytes``."""

    def _reopen(self, i: int) -> None:
        reopen = getattr(self.store, "reopen", None)
        if reopen is not None:
            reopen(i)

    def _take_buffer(self) -> torch.Tensor:
        """A free staging buffer; once its last copy to the card is done."""
        with self._cv:
            if not self._ring_made:
                n = self._buf_nbytes
                for _ in range(self._n_buffers):
                    self._free.append((torch.empty(
                        n, dtype=torch.uint8, pin_memory=self.on_card),
                        None))
                self._ring_made = True
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

    def _leaves(self, buf: torch.Tensor) -> Params:
        """A staged layer's leaves as views of the flat ``buf``."""
        return self.store.leaves(buf)

    def _to_card(self, buf: torch.Tensor, nbytes: int):
        """Host-to-device copy of a staged layer on the side stream; the
        staging buffer goes back to the ring with the copy's event."""
        with torch.cuda.stream(self._side):
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dev.copy_(buf[:nbytes], non_blocking=True)
            tree = self._leaves(dev)         # unaligned leaves copy here
            event = torch.cuda.Event()
            event.record(self._side)
        self._give_back(buf, event)
        return tree, event


class LayerPrefetcher(_Staging):
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
        # window + 1 buffers: the in-window layers plus, at most, one read
        # that was in flight when the front moved past it
        self._n_buffers = self.window + 1
        self._buf_nbytes = store.layer_nbytes
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


# --------------------------------------------------------------------------- #
#  the streamed piped ring
# --------------------------------------------------------------------------- #

class _PassStaging(_Staging):
    """What the streamed ring's prefetchers share: a pass is a list of
    units (a microstep's bank, or a rank's window), each a list of layer
    rows. A worker thread stages the pass's units in order, at most
    ``depth`` units past the compute front (the unit in use counts): each
    layer a unit holds is read once a pass through ``policy`` with
    ``health`` (``_read``: one memcpy out of the mmap into a pinned
    staging buffer), copied to the card on the side stream, shared by
    every later unit of the pass that holds it and released after the
    last one (``done``), behind the front. Rows past the model's layers
    (ring padding) share one zero layer, released like a read one.
    ``get(t)`` returns unit t's trees, views of the staged device
    buffers, and makes the compute stream wait on their copies. Staged
    bytes lease from ``memory`` (host while staging, device once on the
    card); ``stats()`` gives ``PrefetchStats``; with a tracer,
    ``layer_read[i]`` and ``<unit>[t]`` (the worker's time to stage the
    unit) spans land on the ``ring-prefetcher`` track and blocked ``get``
    calls on ``decode``. On the CPU staged layers stay on the host
    (private copies). Subclasses set ``unit`` and may give ``_read``,
    ``_leaves`` and ``_where``."""

    unit = "bank"

    def __init__(self, store: ParamStore, units: List[List[int]],
                 n_layers: int, *, row_nbytes: int, depth: int = 2,
                 device="cuda", policy: Optional[IOPolicy] = None,
                 tracer=None, memory: Optional[TierManager] = None,
                 owner: str = "weights"):
        self.store = store
        self.depth = max(depth, 1)
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        if self.on_card and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.policy = policy or IOPolicy()
        self.tracer = resolve_tracer(tracer)
        self.memory = memory if memory is not None \
            else TierManager(name="ring-prefetch-memory")
        self.owner = owner
        self.health = WorkerHealth(name=type(self).__name__)
        self._side = torch.cuda.Stream(self.device) if self.on_card else None
        self._free: deque = deque()
        self._ring_made = False
        self._n_buffers = 2          # one being filled, one being copied
        self._buf_nbytes = self.row_nbytes = row_nbytes
        self.n_layers = n_layers
        # padding rows are one key, the zero layer's
        self._units = [[min(int(g), n_layers) for g in rows]
                       for rows in units]
        self._last_use = {g: t for t, rows in enumerate(self._units)
                          for g in rows}
        # layer -> (tree, nbytes, tier, copy event or None)
        self._staged: Dict[int, Tuple[Params, int, str, Any]] = {}
        self._ready: Dict[int, List[Tuple[Params, Any]]] = {}
        self._cv = threading.Condition()
        self._stop = False
        self._interrupted = False
        self._error: Optional[BaseException] = None
        self._want: deque = deque()
        self._front = -1                  # last unit done this pass
        self.passes = 0
        self._resident = 0
        self._peak = 0
        self._read_bytes = 0
        self._stall = 0.0
        self._served = 0
        self._events: List[PrefetchEvent] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- staging ----------------------------------------------------------- #

    def _read(self, i: int) -> Tuple[torch.Tensor, float, float]:
        return self._stage(i)

    def _where(self) -> str:
        return ""

    def _hold(self, nbytes: int) -> None:
        with self._cv:
            self._resident += nbytes
            self._peak = max(self._peak, self._resident)

    def _zero_layer(self) -> Tuple[Params, Any]:
        n = self.row_nbytes
        tier = "device" if self.on_card else "host"
        self.memory.lease(tier, n, self.owner, wait=True,
                          timeout=self.policy.op_deadline_s,
                          cancelled=lambda: self._stop)
        buf = torch.zeros(n, dtype=torch.uint8,
                          device=self.device if self.on_card else "cpu")
        tree = self._leaves(buf)
        with self._cv:
            self._staged[self.n_layers] = (tree, n, tier, None)
        self._hold(n)
        return tree, None

    def _layer(self, layer: int) -> Tuple[Params, Any]:
        """Layer ``layer``'s staged tree and copy event (None on the
        host): staged now unless this pass staged it already."""
        ent = self._staged.get(layer)
        if ent is not None:
            return ent[0], ent[3]
        if layer == self.n_layers:
            return self._zero_layer()
        n = self.row_nbytes
        self.memory.lease("host", n, self.owner, wait=True,
                          timeout=self.policy.op_deadline_s,
                          cancelled=lambda: self._stop)
        try:
            buf, t0, t1 = self.policy.run(
                f"layer_read[{layer}]", lambda: self._read(layer),
                reopen=lambda: self._reopen(layer), health=self.health)
        except BaseException:
            self.memory.release("host", n, self.owner)
            raise
        if self.on_card:
            try:
                self.memory.lease("device", n, self.owner, wait=True,
                                  timeout=self.policy.op_deadline_s,
                                  cancelled=lambda: self._stop)
            except BaseException:
                self._give_back(buf)
                self.memory.release("host", n, self.owner)
                raise
            tree, event = self._to_card(buf, n)
            self.memory.release("host", n, self.owner)
            tier = "device"
        else:
            tree, event = self._leaves(buf[:n].clone()), None
            self._give_back(buf)
            tier = "host"
        self.tracer.span_event(f"layer_read[{layer}]", t0, t1,
                               cat="prefetch", track="ring-prefetcher",
                               nbytes=n)
        with self._cv:     # bookkeeping races with done()'s releases
            self._staged[layer] = (tree, n, tier, event)
            self._read_bytes += n
            self._events.append(PrefetchEvent(layer, t0, t1, n))
        self._hold(n)
        return tree, event

    def _worker(self) -> None:
        if self.on_card:
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                # never more than ``depth`` units past the front: what
                # bounds the staged bytes by the windows, not the model
                while not self._stop and (
                        not self._want
                        or self._want[0] > self._front + self.depth):
                    self._cv.wait()
                if self._stop:
                    return
                t = self._want.popleft()
            try:
                with self.tracer.span(f"{self.unit}[{t}]", cat="prefetch",
                                      track="ring-prefetcher"):
                    rows = [self._layer(g) for g in self._units[t]]
            except (KeyboardInterrupt, SystemExit):
                with self._cv:
                    self._stop = True
                    self._interrupted = True
                    self._cv.notify_all()
                raise
            except BaseException as e:   # surface in get(), don't deadlock
                with self._cv:
                    self._error = e
                    self._cv.notify_all()
                return
            with self._cv:
                self._ready[t] = rows
                self._cv.notify_all()

    # -- front side -------------------------------------------------------- #

    def begin_pass(self) -> None:
        """Enqueue the pass's units (staged ``depth`` ahead); what an
        unfinished pass left staged is released."""
        with self._cv:
            if self._error is not None:
                raise RuntimeError(f"{self._where()}{self.unit} staging "
                                   f"failed ({self.health.report()})") \
                    from self._error
            self._ready.clear()
            for layer in list(self._staged):
                self._drop_locked(layer)
            self._front = -1
            self._want.clear()
            self._want.extend(range(len(self._units)))
            self.passes += 1
            self._cv.notify_all()

    def _drop_locked(self, layer: int) -> None:
        _, nbytes, tier, _ = self._staged.pop(layer)
        self._resident -= nbytes
        self.memory.release(tier, nbytes, self.owner)
        if layer < self.n_layers:
            self.store.release(layer)

    def get(self, t: int, *, timeout: Optional[float] = None) -> List[Params]:
        """Block until unit ``t`` is staged (at most ``timeout`` seconds,
        default the policy's ``get_timeout_s``); returns its layer trees
        in row order. On the card the current stream waits for their
        copies."""
        if timeout is None:
            timeout = self.policy.get_timeout_s
        deadline = clock() + timeout
        unit = self.unit
        with self._cv:
            t0 = clock()
            with self.tracer.phase("disk_wait", cat="prefetch",
                                   track="decode", min_dur=2e-4,
                                   label=f"{unit}_wait[{t}]"):
                while t not in self._ready:
                    if self._error is not None:
                        raise RuntimeError(
                            f"{self._where()}{unit} staging failed at "
                            f"{unit} {t} ({self.health.report()})") \
                            from self._error
                    if self._stop:
                        raise RuntimeError(
                            f"{unit} prefetcher stopped" + (
                                " (worker interrupted)"
                                if self._interrupted else ""))
                    remaining = deadline - clock()
                    if remaining <= 0:
                        self.health.stalled = True
                        raise StallTimeout(
                            f"{self._where()}{unit} {t} not staged within "
                            f"{timeout:.1f}s ({self.health.report()})",
                            op=f"{unit}[{t}]")
                    self._cv.wait(min(remaining, 0.25))
            self._stall += clock() - t0
            self._served += 1
            rows = self._ready[t]
        if self.on_card:
            stream = torch.cuda.current_stream(self.device)
            for tree, event in rows:
                if event is not None:
                    stream.wait_event(event)
                for x in tree_tensors(tree):
                    x.record_stream(stream)
        return [tree for tree, _ in rows]

    def done(self, t: int) -> None:
        """Unit ``t`` consumed: drop it and release the layers whose last
        use in the pass it was."""
        with self._cv:
            self._ready.pop(t, None)
            self._front = max(self._front, t)
            for layer in self._units[t]:
                if self._last_use[layer] == t and layer in self._staged:
                    self._drop_locked(layer)
            self._cv.notify_all()

    def stats(self) -> PrefetchStats:
        with self._cv:
            return PrefetchStats(
                events=list(self._events), peak_resident_bytes=self._peak,
                total_bytes_read=self._read_bytes, stall_s=self._stall,
                layers_served=len(self._events),
                releases=self.store.released,
                retries=self.health.retries,
                released_bytes=getattr(self.store, "released_bytes", 0),
                budget_refusals=sum(
                    s.refusals for s in self.memory.stats().values()))

    def close(self, timeout: float = 5.0) -> bool:
        """Stop the worker (idempotent) and hand every lease back; True
        once it has joined."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self.health.stalled = True
            log.error("%s.close: worker failed to join within %.1fs — %s",
                      type(self).__name__, timeout, self.health.report())
            return False
        with self._cv:
            self._ready.clear()
            for layer in list(self._staged):
                self._drop_locked(layer)
        self.health.closed = True
        return True


class RingBankPrefetcher(_PassStaging):
    """Stage each microstep's window bank for the streamed ring.

    The ring schedule needs, at microstep ``t``, a bank whose stage-``m``
    rows hold that stage's round-``r_m(t)`` window
    (``serve.ring_bank_layers``: M*w rows): the units of a pass are its
    ``n_steps`` banks, each layer read whole. A bank is the list of its
    rows' layer trees, views of the staged device buffers: the JAX
    package stacks a bank into one array for its sharded ``device_put``,
    which on one card would move the same bytes again every step.
    """

    def __init__(self, store: ParamStore, cfg, plan, *, depth: int = 2,
                 device="cuda", policy: Optional[IOPolicy] = None,
                 tracer=None, memory: Optional[TierManager] = None,
                 owner: str = "weights"):
        from .serve import ring_bank_layers

        self.plan = plan
        self.n_steps = plan.n_steps
        super().__init__(
            store, [ring_bank_layers(plan, t) for t in range(self.n_steps)],
            cfg.n_layers, row_nbytes=store.layer_nbytes, depth=depth,
            device=device, policy=policy, tracer=tracer, memory=memory,
            owner=owner)


class RankWindowPrefetcher(_PassStaging):
    """Stage one rank's windows of the ring across ranks from the layer
    store: the counterpart of the JAX ``RingBankPrefetcher`` over a
    sharded bank, where each device receives only its shard of a bank.

    A rank runs only its stage's k windows of w rows a pass
    (``serve._rank_rows``), window r over microbatches 0..M-1 in a row,
    so the units of its pass are those windows and it stages nothing of
    another stage: at most ``depth`` windows are staged (the window in
    use counts) and ``done(r)`` releases window r after its last
    microbatch. Of each row it reads only the rank's part of every leaf,
    cut by the ring's specs (``serve.rank_layer_cuts``, the cuts
    ``rank_params`` makes) straight out of the mapped layer file into a
    pinned staging buffer (one copy a leaf; q4 leaves as packed rows and
    scale rows together), then one host-to-device copy of the rank's
    flat layer. Padding rows share one zero layer at the rank's shapes.
    The leases are the rank's own books. ``get(r)`` returns window r's w
    blocks prepared as ``serve.rank_params`` prepares a row, so
    ``serve.RankRingStep`` runs them as it runs its resident rows.
    """

    unit = "window"

    def __init__(self, store: ParamStore, cfg, plan, layout, *,
                 depth: int = 2, policy: Optional[IOPolicy] = None,
                 tracer=None):
        from .serve import _rank_rows, rank_layer_cuts

        self.plan, self.layout = plan, layout
        self.cuts = rank_layer_cuts(store.layer_leaves, plan, layout)
        self._local = [c.local for c in self.cuts]
        self.local_nbytes = sum(c.local.nbytes for c in self.cuts)
        rows = _rank_rows(plan, layout.stage)
        w = plan.w
        self.windows = [[int(g) for g in rows[r * w:(r + 1) * w]]
                        for r in range(plan.k)]
        super().__init__(
            store, self.windows, cfg.n_layers, row_nbytes=self.local_nbytes,
            depth=depth, device=layout.device, policy=policy, tracer=tracer,
            memory=TierManager(name="rank-prefetch-memory"))

    def _leaves(self, buf: torch.Tensor) -> Params:
        from .paramstore import _read_leaves

        return _read_leaves(self._local, buf)

    def _read(self, i: int) -> Tuple[torch.Tensor, float, float]:
        """Copy the rank's part of layer i out of the mapping into a
        staging buffer, a leaf at a time (no read-ahead hint: it would
        pull the whole file); returns (the buffer, t_start, t_end)."""
        t0 = clock()
        src = self.store.layer_bytes(i)
        buf = self._take_buffer()
        try:
            for c in self.cuts:
                c.copy(src, buf, self.layout.mesh, self.layout.coords)
        except BaseException:
            self._give_back(buf)
            raise
        return buf, t0, clock()

    def _where(self) -> str:
        lay = self.layout
        return f"rank {lay.rank} (stage {lay.stage}, member {lay.member}): "

    def get(self, r: int, *, timeout: Optional[float] = None) -> List:
        """Window ``r``'s w blocks (``_PassStaging.get``'s trees, prepared
        as ring rows)."""
        from ..bridge import block_from_tree
        from .serve import _prep_ring_layer

        return [block_from_tree(_prep_ring_layer(tree))
                for tree in super().get(r, timeout=timeout)]

    def report(self) -> Dict[str, Any]:
        """What a rank reports of its streaming: passes, bytes read in all
        and a pass, the rank's bytes a row, layer reads, peak staged
        bytes, stall seconds and retries."""
        st = self.stats()
        return {"passes": self.passes, "bytes_read": st.total_bytes_read,
                "bytes_a_pass": st.total_bytes_read / max(self.passes, 1),
                "row_nbytes": self.local_nbytes, "reads": len(st.events),
                "peak_staged_bytes": st.peak_resident_bytes,
                "stall_s": st.stall_s, "retries": st.retries}


class StreamingRingDriver:
    """The piped ring whose window banks stream from a layer store.

    Where ``serve.RingServeStep`` runs over the whole ring-ordered bank
    resident, this driver holds only the banks of the microsteps around
    the compute front: it runs the ``k*M + M - 1`` microsteps of a pass
    itself, over banks staged by ``RingBankPrefetcher`` — the disk read
    and host-to-device copy of step t+1's bank overlap the compute of
    step t, and layers behind the front are released. The KV cache stays
    on the device (``serve.init_ring_cache``'s layout). The head (embed,
    final norm, unembed) is ``head`` (on ``device``), else it loads once
    from ``store.head()``.
    ``step(cache, tokens (B, T)) -> (logits, cache)`` as the resident
    step (eager: its weights come in rotating buffers), T =
    ``n_tokens``; with a tracer each pass is one ``ring_token[i]`` step
    on ``decode`` whose embed, microsteps and head are phases on the
    ``ring`` track. The counterpart of the JAX package's
    ``StreamingRingDriver`` over ``build_ring_stream_step``.
    """

    def __init__(self, cfg, plan, store: ParamStore, *, n_tokens: int = 1,
                 prefetch_depth: int = 2, device="cuda",
                 policy: Optional[IOPolicy] = None, tracer=None,
                 memory: Optional[TierManager] = None,
                 head: Optional[Params] = None):
        from ..bridge import block_from_tree
        from .serve import _prep_ring_layer, pad_vocab

        if n_tokens > 1 and cfg.family == "ssm":
            raise ValueError("speculative verify needs a rollbackable KV "
                             "cache")
        self.cfg, self.plan, self.n_tokens = cfg, plan, n_tokens
        self.tracer = resolve_tracer(tracer)
        self.device = torch.device(device)
        if head is None:
            head = map_tree(lambda t: t.to(self.device),
                            pad_vocab(store.head(), cfg, 1))
        self.head = head
        self.prefetch = RingBankPrefetcher(store, cfg, plan,
                                           depth=prefetch_depth,
                                           device=device, policy=policy,
                                           tracer=tracer, memory=memory)
        self.n_steps = self.prefetch.n_steps
        self._block = lambda tree: block_from_tree(_prep_ring_layer(tree))
        self._token_idx = 0

    def step(self, cache: Dict, tokens: torch.Tensor):
        """One pass (every layer streamed once): (logits, cache)."""
        from .serve import check_ring_cache

        if tokens.shape[1] != self.n_tokens:
            raise ValueError(f"a {self.n_tokens}-token ring step got "
                             f"{tokens.shape[1]} tokens a sequence")
        check_ring_cache(self.cfg, self.plan, cache)
        with self.tracer.token_step(self._token_idx, track="decode",
                                    name=f"ring_token[{self._token_idx}]"):
            self._token_idx += 1
            return self._pass(cache, tokens)

    def _pass(self, cache, tokens):
        from .serve import ring_pass

        w = self.plan.w
        bank: Dict[int, List] = {}

        def window(t, m, r):
            if t not in bank:
                bank.clear()
                bank[t] = [self._block(tree)
                           for tree in self.prefetch.get(t)]
            return bank[t][m * w:(m + 1) * w]

        def done(t):
            bank.clear()
            self.prefetch.done(t)

        self.prefetch.begin_pass()
        logits, cache = ring_pass(self.cfg, self.plan, self.head, window,
                                  cache, tokens, on_step=done,
                                  tracer=self.tracer)
        if self.device.type == "cuda":
            with self.tracer.phase("compute", cat="ring", track="ring",
                                   label="sync"):
                torch.cuda.current_stream(self.device).synchronize()
        return logits, cache

    def stats(self) -> PrefetchStats:
        return self.prefetch.stats()

    def health(self) -> WorkerHealth:
        return self.prefetch.health

    def close(self, timeout: float = 5.0) -> bool:
        return self.prefetch.close(timeout=timeout)
