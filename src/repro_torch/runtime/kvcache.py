"""Paged KV cache of the port: block-pool allocator, prefix reuse, the
memory tiers behind it, and the paged continuous-batching engine.

Counterpart of ``repro.runtime.kvcache`` with a torch page pool:

  * ``BlockPool`` — fixed-size token pages with refcounts; refcount-0
    pages stay content-addressed as a prefix cache, evicted least
    recently used first (``evict_policy="lru"``) or at the least modeled
    recall loss (``"cost"``);
  * prefix reuse — every full prompt page (and the final partial page) is
    keyed by its exact chained token key (compared by value, so a
    collision never shares the wrong bytes); writes into a shared page
    copy-on-write at the divergence page;
  * host offload (``BlockOffloader``) — an evicted prefix page is copied
    to host memory instead of being dropped; a later prefix hit on it
    allocates a device page and fetches the bytes back on a worker
    thread, so the copy overlaps the admit's prefill compute;
  * the tiers — every resident byte (the device pool, host copies, disk
    page files) leases from one ``runtime.memory.TierManager``; a full
    host tier spills the oldest host pages to a ``PageFileStore`` disk
    tier; ``quantize_page`` int8-compresses offloaded pages
    (``offload_quant=True``); idle sessions park to host, demote to
    per-session page files and restore byte-identically
    (``park_session`` / ``sweep_parked`` / ``restore_session``);
  * ``PagedKVCache`` — per-slot page lists, admission with worst-case
    page reservation, chunked admission, and the device block table.

Device state lives in the engine-threaded cache dict
(``{"pages", "block_table", "len"}``). Page contents are written in place:
the pool is allocated once and never again (a graphed step reads its
tensors at fixed addresses), and fetched or restored pages are copied into
it on the compute stream.

Host pages. A page on the host is one flat byte buffer holding its leaves
sorted by name (``page_layout``: name, shape, torch dtype's numpy name,
offset, bytes) — the page file's own layout, so a spill writes the buffer
and a disk recall reads the file straight back into one. On the card the
buffers are pinned, taken from ``HostPages``, a pool that pins a chunk of
page buffers at a time and reuses them (pinning is slow); their bytes
still lease from the ``host`` tier page by page. With ``device="cpu"`` the
buffers are plain CPU tensors.

Copies on the card. Eviction copies the page device-to-host on the
compute stream and waits for that stream before ``offload`` returns, so
the copy runs after every kernel queued before it and is complete before
the allocator hands the page to the admit that evicted it. A fetch copies
host-to-device on the offloader's own stream from its worker thread, into
a staging buffer; the compute stream waits on the copy's event, the
staging buffer is marked in use by the compute stream, and the page is
copied into the pool there. A failed device-to-host or host-to-device copy
raises through the ``IOPolicy`` as ``kv_d2h`` or ``kv_h2d``, a page file
as ``kv_d2disk`` or ``kv_disk2h``; no path drops a page it reports as a
hit.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.latency import kv_recall_costs
from .engine import (ContinuousBatcher, GraphedDecode, StepGraphs,
                     cache_tensors, saved)
from .iopolicy import (BudgetExceeded, IOPolicy, ShortReadError,
                       StallTimeout, WorkerHealth)
from .memory import TierManager
from .paramstore import LeafSpec, _dtype_name, _read_leaves
from .streaming import PrefetchEvent, PrefetchStats
from .telemetry import clock, resolve_tracer

log = logging.getLogger(__name__)

Tree = Dict[str, torch.Tensor]

#: page id 0 is a write sink: freed slots keep decoding junk into it (the
#: batch is fixed-width, inactive rows still run), so it is never handed
#: out by the allocator and its content is never read unmasked.
SINK_PAGE = 0


def _upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Host array -> device tensor, in place and without a sync: staged
    through pinned memory, which the caching host allocator keeps until
    the copy has run."""
    t = torch.from_numpy(src)
    if dst.is_cuda:
        dst.copy_(t.pin_memory(), non_blocking=True)
    else:
        dst.copy_(t)


class PoolExhausted(RuntimeError):
    """The block pool cannot satisfy an allocation (clear admit error)."""


def chain_key(prev: tuple, tokens: Sequence[int], count: int) -> tuple:
    """Content key of a prompt page given its predecessor's key: the
    nested token chain itself (not a digest), with ``count`` so a partial
    page only matches an identical partial page. Start with ``()``."""
    return (prev, count, tuple(int(t) for t in tokens))


# --------------------------------------------------------------------------- #
#  block pool (host-side allocator)
# --------------------------------------------------------------------------- #

class BlockPool:
    """Refcounted fixed-size page allocator with a prefix cache.

    Page states: free (on the free list), active (refcount >= 1), cached
    (refcount 0 but still content-addressable, evicted when the free list
    runs dry; ``alloc(evict_cb=)`` lets the owner offload the bytes
    first). ``release`` of a non-active page raises.

    Eviction of cached pages: ``evict_policy="lru"`` takes the least
    recently used; ``"cost"`` the page minimizing *expected recall loss*,
    ``(1 + hit count) * recall_cost_fn(key)``, where ``recall_cost_fn``
    prices bringing the page back from wherever eviction would land it
    (``core.latency.kv_recall_costs``) — so a hot page whose recall would
    come from disk outlives a cold page recallable from host.
    """

    def __init__(self, n_pages: int, page_tokens: int, *,
                 evict_policy: str = "lru",
                 recall_cost_fn: Optional[Callable[[Any], float]] = None):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the write sink)")
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        if evict_policy not in ("lru", "cost"):
            raise ValueError(f"unknown evict_policy {evict_policy!r} "
                             f"(expected 'lru' or 'cost')")
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self.evict_policy = evict_policy
        self.recall_cost_fn = recall_cost_fn
        self._free: List[int] = list(range(n_pages - 1, SINK_PAGE, -1))
        self._ref: Dict[int, int] = {}
        self._hash_of: Dict[int, Any] = {}       # pid -> registered key
        self._pid_of: Dict[Any, int] = {}        # content key -> pid
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU, ref 0
        self._freq: Dict[Any, int] = {}          # content key -> reuse hits
        self.alloc_count = 0
        self.evictions = 0

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def lookup(self, h) -> Optional[int]:
        """Device page registered under content key ``h`` (or None); a hit
        feeds the key's reuse frequency, which cost eviction weighs."""
        pid = self._pid_of.get(h)
        if pid is not None:
            self._freq[h] = self._freq.get(h, 0) + 1
        return pid

    def note_hit(self, h) -> None:
        """Record a reuse of key ``h`` served off the device (an offloaded
        copy): the same frequency signal as a resident ``lookup`` hit."""
        self._freq[h] = self._freq.get(h, 0) + 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return len(self._ref)

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    def available(self) -> int:
        """Pages an alloc burst could obtain (free + evictable cached)."""
        return len(self._free) + len(self._cached)

    def alloc(self, *, evict_cb=None) -> int:
        """Take a page (refcount 1), evicting a cached page when the free
        list is empty — ``evict_cb(pid, key)`` runs first so the owner can
        offload the content; raises ``PoolExhausted`` when neither has
        one."""
        if self._free:
            pid = self._free.pop()
        elif self._cached:
            pid = self._pick_victim()
            del self._cached[pid]
            h = self._hash_of.pop(pid)
            del self._pid_of[h]
            self.evictions += 1
            if evict_cb is not None:
                evict_cb(pid, h)
        else:
            raise PoolExhausted(
                f"KV block pool exhausted: {self.n_pages - 1} pages, "
                f"{self.n_active} active, none cached/free")
        self._ref[pid] = 1
        self.alloc_count += 1
        return pid

    def _pick_victim(self) -> int:
        """LRU: the oldest cached page. Cost: the least expected recall
        loss, ``(1 + reuse hits) * modeled recall seconds`` (LRU order
        breaks ties); LRU without a pricing function."""
        if self.evict_policy == "cost" and self.recall_cost_fn is not None:
            return min(
                self._cached,
                key=lambda p: (1 + self._freq.get(self._hash_of[p], 0))
                * self.recall_cost_fn(self._hash_of[p]))
        return next(iter(self._cached))

    def retain(self, pid: int) -> None:
        """Add a reference (prefix share / cached-page revival)."""
        if pid == SINK_PAGE:
            raise ValueError("cannot retain the sink page")
        if pid in self._cached:
            del self._cached[pid]
            self._ref[pid] = 1
        else:
            if pid not in self._ref:
                raise ValueError(f"retain of non-active page {pid}")
            self._ref[pid] += 1

    def release(self, pid: int) -> None:
        """Drop a reference; at zero the page goes to the prefix cache if
        content-addressed, otherwise back to the free list."""
        n = self._ref.get(pid)
        if n is None:
            raise ValueError(f"double free of page {pid}")
        if n > 1:
            self._ref[pid] = n - 1
            return
        del self._ref[pid]
        if pid in self._hash_of:
            self._cached[pid] = None
            self._cached.move_to_end(pid)
        else:
            self._free.append(pid)

    def register(self, h, pid: int) -> None:
        """Make an active page addressable by content key ``h``."""
        if pid not in self._ref:
            raise ValueError(f"register of non-active page {pid}")
        old = self._pid_of.get(h)
        if old is not None and old != pid:
            return                       # identical content: keep the older
        self._pid_of[h] = pid
        self._hash_of[pid] = h

    def unregister(self, pid: int) -> None:
        """Forget a page's key (it is about to be written in place)."""
        h = self._hash_of.pop(pid, None)
        if h is not None:
            self._pid_of.pop(h, None)

    def check(self) -> None:
        """Invariants (tests)."""
        free, active, cached = set(self._free), set(self._ref), \
            set(self._cached)
        if SINK_PAGE in free | active | cached:
            raise AssertionError("sink page entered the allocator")
        if free & active or free & cached or active & cached:
            raise AssertionError("page in two states")
        if len(free) + len(active) + len(cached) != self.n_pages - 1:
            raise AssertionError("pages leaked")
        if any(n < 1 for n in self._ref.values()):
            raise AssertionError("active page with refcount < 1")
        if not cached <= set(self._hash_of):
            raise AssertionError("cached page without a key")
        for h, pid in self._pid_of.items():
            if self._hash_of.get(pid) != h:
                raise AssertionError("key maps disagree")


# --------------------------------------------------------------------------- #
#  int8 page quantization (quantize-on-write during offload)
# --------------------------------------------------------------------------- #

_SCALE_SUFFIX = "::scale"


def quantize_page(tree: Tree) -> Tree:
    """Symmetric per-vector int8 quantization of a page tree (on the
    tensors' own device): each last-axis vector gets an ``amax/127``
    float32 scale stored under ``<leaf>::scale``. The leaves are upcast
    to float32 first, as the JAX package's numpy version does, so the
    bytes equal it. Lossy, so it is applied only to evicted prefix-cache
    pages — never to parked sessions, whose restore must be exact."""
    out: Tree = {}
    for name, a in tree.items():
        f = a.float()
        scale = f.abs().amax(dim=-1, keepdim=True) / 127.0
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        out[name] = torch.clamp(torch.round(f / scale), -127, 127) \
            .to(torch.int8)
        out[name + _SCALE_SUFFIX] = scale
    return out


def dequantize_page(tree: Tree, dtype: torch.dtype) -> Tree:
    """Inverse of :func:`quantize_page` (cast back to the pool dtype)."""
    out: Tree = {}
    for name, a in tree.items():
        if name.endswith(_SCALE_SUFFIX):
            continue
        scale = tree.get(name + _SCALE_SUFFIX)
        out[name] = a if scale is None else (a.float() * scale).to(dtype)
    return out


def is_quantized_page(tree) -> bool:
    return any(k.endswith(_SCALE_SUFFIX) for k in tree)


# --------------------------------------------------------------------------- #
#  host pages: flat buffers in the page file's layout
# --------------------------------------------------------------------------- #

def page_layout(tree: Tree) -> List[LeafSpec]:
    """The flat layout of a page tree: its leaves sorted by name, packed
    back to back (the page file's layout, the JAX package's too)."""
    specs, offset = [], 0
    for name in sorted(tree):
        t = tree[name]
        n = t.numel() * t.element_size()
        specs.append(LeafSpec(key=name, shape=tuple(int(d) for d in t.shape),
                              dtype=_dtype_name(t.dtype), offset=offset,
                              nbytes=n))
        offset += n
    return specs


def layout_nbytes(specs: List[LeafSpec]) -> int:
    return sum(s.nbytes for s in specs)


def page_tree(buf: torch.Tensor, specs: List[LeafSpec]) -> Tree:
    """A page tree as views of the flat ``buf`` (an unaligned leaf is
    copied)."""
    return _read_leaves(specs, buf)


def _leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """A leaf's bytes in row-major order as a flat uint8 tensor, on its
    device (a strided view is made contiguous there first)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


class HostPages:
    """Reusable host buffers for pages, by size.

    On the card (``pin=True``) each growth pins ``CHUNK`` buffers with one
    allocation, and a buffer handed back is reused, never unpinned before
    ``close``: pinning is a slow driver call, an eviction is on the
    admit's path. ``give(buf, event)``: the buffer is reused only once
    ``event`` (a copy out of it) has completed. The bytes a buffer holds
    lease from the ``host`` tier by whoever holds it, not here.
    """

    CHUNK = 8

    def __init__(self, *, pin: bool):
        self.pin = pin
        self._free: Dict[int, List[Tuple[torch.Tensor, Any]]] = {}
        self._slabs: List[torch.Tensor] = []
        self._lock = threading.Lock()
        self.pinned_bytes = 0

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            free = self._free.setdefault(nbytes, [])
            if not free:
                n = self.CHUNK if self.pin else 1
                slab = torch.empty(n * nbytes, dtype=torch.uint8,
                                   pin_memory=self.pin)
                if self.pin:
                    self._slabs.append(slab)
                    self.pinned_bytes += slab.numel()
                free.extend((slab[k * nbytes:(k + 1) * nbytes], None)
                            for k in range(n))
            buf, event = free.pop()
        if event is not None:
            event.synchronize()
        return buf

    def give(self, buf: torch.Tensor, event=None) -> None:
        with self._lock:
            self._free.setdefault(buf.numel(), []).append((buf, event))

    def close(self) -> None:
        with self._lock:
            self._free.clear()
            self._slabs.clear()


def _to_host(pages: HostPages, tree: Tree, specs: List[LeafSpec],
             timings: Optional[list] = None) -> torch.Tensor:
    """Copy a page tree (on any device) into a host buffer of ``pages``;
    returns it once the copy is complete. On the card the copies run on
    the current (compute) stream, after everything queued on it, and the
    host waits for that stream: a page freed after this returns can be
    written at once. ``timings`` collects (start, end) CUDA events."""
    buf = pages.take(layout_nbytes(specs))
    try:
        src = [_leaf_bytes(tree[s.key]) for s in specs]
        cuda = any(t.is_cuda for t in src)
        if cuda:
            stream = torch.cuda.current_stream(src[0].device)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
        for s, t in zip(specs, src):
            buf[s.offset:s.offset + s.nbytes].copy_(t, non_blocking=cuda)
        if cuda:
            ev[1].record(stream)
            stream.synchronize()
            if timings is not None:
                timings.append(ev)
    except BaseException:
        pages.give(buf)
        raise
    return buf


# --------------------------------------------------------------------------- #
#  disk tier (per-session / per-page page files)
# --------------------------------------------------------------------------- #

class PageFileStore:
    """Disk tier for KV pages: one flat binary file per key, the leaves
    sorted by name as raw bytes (byte-identical to the JAX package's
    files for the same tree), the index in memory.

    Keys are arbitrary hashables (content chain keys for spilled
    prefix-cache pages, ``("sess", id, j)`` for a parked session's page
    files); the index is scoped to one serving process like the pool it
    backs. Writes run under the shared :class:`IOPolicy` as op
    ``kv_d2disk`` and reads as ``kv_disk2h`` — both injectable by
    ``faults.FaultInjector`` and retried/deadlined like layer reads.
    ``get`` returns private CPU copies; ``read_into`` reads a page file
    straight into a caller's flat buffer (a pinned host page).
    """

    def __init__(self, directory: str, *,
                 policy: Optional[IOPolicy] = None, injector=None,
                 tracer=None):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.policy = policy or IOPolicy()
        self.injector = injector
        self.tracer = resolve_tracer(tracer)
        self.health = WorkerHealth(name="PageFileStore")
        #: key -> (path, layout)
        self._index: Dict[Any, Tuple[str, List[LeafSpec]]] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self.written_bytes = 0
        self.read_bytes = 0
        self.events: List[PrefetchEvent] = []     # read (recall) timeline

    def holds(self, key) -> bool:
        with self._lock:
            return key in self._index

    def nbytes(self, key) -> int:
        with self._lock:
            ent = self._index.get(key)
            return layout_nbytes(ent[1]) if ent else 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def path(self, key) -> str:
        """The file holding ``key`` (tests, fault drills)."""
        with self._lock:
            return self._index[key][0]

    def put(self, key, tree: Tree) -> int:
        """Persist a flat page tree (tensors on any device) under ``key``;
        returns bytes written."""
        specs = page_layout(tree)
        parts = [_leaf_bytes(tree[s.key]).cpu() for s in specs]
        return self._put(key, specs, parts)

    def put_flat(self, key, buf: torch.Tensor,
                 specs: List[LeafSpec]) -> int:
        """Persist a host page already in the file layout (a spill)."""
        return self._put(key, specs, [buf[:layout_nbytes(specs)]])

    def _put(self, key, specs: List[LeafSpec],
             parts: List[torch.Tensor]) -> int:
        """Atomic per key: the index only records a fully written file,
        and a retried write starts the file over."""
        with self._lock:
            path = os.path.join(self.directory,
                                f"page_{self._seq:06d}.bin")
            self._seq += 1
        total = layout_nbytes(specs)

        def write() -> int:
            if self.injector is not None:
                self.injector.check("kv_d2disk", key=key)
            with open(path, "wb") as f:
                for p in parts:
                    f.write(memoryview(p.numpy()))
            return total

        t0 = clock()
        self.policy.run("kv_d2disk", write, health=self.health)
        self.tracer.span_event(f"kv_d2disk[{key}]", t0, clock(), cat="kv",
                               track="kv-offloader", nbytes=total)
        with self._lock:
            self._index[key] = (path, specs)
            self.written_bytes += total
        return total

    def read_into(self, key, out: torch.Tensor) -> List[LeafSpec]:
        """Read ``key``'s file into the flat CPU uint8 ``out`` (at least
        its size); returns the layout. A short file is a
        ``ShortReadError`` (transient: retried under the policy)."""
        with self._lock:
            path, specs = self._index[key]
        total = layout_nbytes(specs)

        def read() -> None:
            if self.injector is not None:
                self.injector.check("kv_disk2h", key=key)
            with open(path, "rb") as f:
                got = f.readinto(memoryview(out[:total].numpy()))
            if got != total:
                raise ShortReadError(
                    f"page file {path} holds {got} of {total} bytes",
                    path=path, expected=total, got=got)

        t0 = clock()
        self.policy.run("kv_disk2h", read, health=self.health)
        t1 = clock()
        self.tracer.span_event(f"kv_disk2h[{key}]", t0, t1, cat="kv",
                               track="kv-offloader", nbytes=total)
        with self._lock:
            self.read_bytes += total
            self.events.append(PrefetchEvent(0, t0, t1, total))
        return specs

    def get(self, key) -> Tree:
        """Read a page tree back (private CPU copies, byte-identical)."""
        buf = torch.empty(self.nbytes(key), dtype=torch.uint8)
        return page_tree(buf, self.read_into(key, buf))

    def drop(self, key) -> int:
        """Forget ``key`` and delete its file; returns bytes freed."""
        with self._lock:
            ent = self._index.pop(key, None)
        if ent is None:
            return 0
        path, specs = ent
        try:
            os.unlink(path)
        except FileNotFoundError:   # pragma: no cover - already gone
            pass
        return layout_nbytes(specs)

    def close(self) -> None:
        with self._lock:
            entries = list(self._index.values())
            self._index.clear()
        for path, _ in entries:
            try:
                os.unlink(path)
            except FileNotFoundError:   # pragma: no cover - already gone
                pass


# --------------------------------------------------------------------------- #
#  host offload (staged fetch on a worker thread)
# --------------------------------------------------------------------------- #

class BlockOffloader:
    """Host store of evicted pages + staged device fetches.

    ``offload(h, tree)`` (the eviction path) copies a page's bytes to a
    host buffer before it returns: it runs inside an allocation that
    needs the device page now. ``schedule(h)`` queues the reverse copy on
    a worker thread; ``get(h)`` blocks until it is staged on the device
    and returns the page tree there. Fetches are scheduled at admit time
    and collected after the admit's prefill compute, so the copy overlaps
    compute.

    Host copies lease from ``memory``'s ``host`` tier (a private,
    unbounded manager when none is passed). A refused lease first
    **spills** the oldest host pages to the ``disk`` store (a
    :class:`PageFileStore`, op ``kv_d2disk``), and only when there is no
    disk store surfaces :class:`BudgetExceeded`, which the policy
    classifies transient (a finishing slot may free host bytes).
    ``quant=True`` int8-quantizes pages on write (``quantize_page``).

    ``device``: where fetched pages are staged (the pool's device); on
    the card the host buffers are pinned (``HostPages``, or the ``pages``
    pool passed in) and ``copy_events`` keeps a (start, end) CUDA event
    pair of each of the last ``KEEP_EVENTS`` device-to-host (``"d2h"``)
    and host-to-device (``"h2d"``) page copies.
    """

    KEEP_EVENTS = 4096

    def __init__(self, *, policy: Optional[IOPolicy] = None,
                 injector=None, tracer=None,
                 memory: Optional[TierManager] = None,
                 owner: str = "kv",
                 disk: Optional[PageFileStore] = None,
                 quant: bool = False, page_dtype=torch.float32,
                 device="cuda", pages: Optional[HostPages] = None) -> None:
        self.policy = policy or IOPolicy()
        self.injector = injector          # faults.FaultInjector or None
        self.tracer = resolve_tracer(tracer)
        self.memory = memory if memory is not None \
            else TierManager(tracer=tracer, name="kv-offload-memory")
        self.owner = owner
        self.disk = disk
        self.quant = quant
        self.page_dtype = page_dtype
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        if self.on_card and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.pages = pages if pages is not None \
            else HostPages(pin=self.on_card)
        self._side = torch.cuda.Stream(self.device) if self.on_card else None
        self.copy_events = {k: deque(maxlen=self.KEEP_EVENTS)
                            for k in ("d2h", "h2d")}
        self.health = WorkerHealth(name="BlockOffloader")
        self.stall_s = 0.0                # get() blocked on a staging fetch
        #: key -> (host buffer, layout, bytes)
        self._host: Dict[Any, Tuple[torch.Tensor, List[LeafSpec], int]] = {}
        self._disk_keys: Dict[Any, int] = {}            # spilled key -> nb
        #: key -> (device buffer, layout, copy event or None)
        self._staged: Dict[Any, Tuple[torch.Tensor, List[LeafSpec], Any]] = {}
        self._queue: List[Any] = []
        #: keys scheduled and not yet collected by ``get``: their host
        #: copies are not spilled (the fetch reads them)
        self._pending: set = set()
        #: key -> spilled: host copies the worker is copying out of now; a
        #: spilled one's buffer is handed back once that copy has ended
        self._reading: Dict[Any, bool] = {}
        self._cv = threading.Condition()
        self._stop = False
        self._interrupted = False
        self._error: Optional[BaseException] = None
        self.events: List[PrefetchEvent] = []
        self.offloaded_bytes = 0
        self.fetched_bytes = 0
        self.spilled_pages = 0            # host pages demoted to disk
        self.fetched_disk_pages = 0       # recalls served from disk
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- fetch side (worker) ---------------------------------------------- #

    def _h2d(self, buf: torch.Tensor, nbytes: int):
        """Host buffer -> a device staging buffer; returns it and, on the
        card, the copy's event (complete when this returns)."""
        if self.injector is not None:
            self.injector.check("kv_h2d")
        if not self.on_card:
            return buf[:nbytes].clone(), None
        with torch.cuda.stream(self._side):
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record(self._side)
            dev.copy_(buf[:nbytes], non_blocking=True)
            done.record(self._side)
        done.synchronize()                # the event's time is the copy's
        self.copy_events["h2d"].append((start, done))
        return dev, done

    def _fetch_host(self, h):
        """Locate a page's bytes on the host: a host hit, or a disk recall
        (``kv_disk2h``) into a host buffer under a transient host lease.
        Returns (buffer, layout, source, bytes) or None."""
        with self._cv:
            ent = self._host.get(h)
            if ent is not None:
                self._reading[h] = False
                return ent[0], ent[1], "host", ent[2]
            on_disk = h in self._disk_keys
        if not on_disk:
            return None
        nbytes = self.disk.nbytes(h)
        # the staging lease must not deadlock against our own host copies:
        # spill the coldest to disk to make room; only wait on the budget
        # once there is nothing left of ours to demote
        acquired = False
        with self._cv:
            while not acquired:
                acquired = self.memory.try_lease("host", nbytes, self.owner)
                if not acquired and not self._spill_one_locked():
                    break
        if not acquired:
            self.memory.lease("host", nbytes, self.owner, wait=True,
                              timeout=self.policy.op_deadline_s,
                              cancelled=lambda: self._stop)
        buf = self.pages.take(nbytes)
        try:
            specs = self.disk.read_into(h, buf)   # policy + injector inside
        except BaseException:
            self.pages.give(buf)
            self.memory.release("host", nbytes, self.owner)
            raise
        return buf, specs, "disk", nbytes

    def _worker(self) -> None:
        if self.on_card:
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                h = self._queue.pop(0)
            try:
                found = self._fetch_host(h)
                if found is None:
                    continue
                buf, specs, src, nbytes = found
                t0 = clock()
                try:
                    dev, event = self.policy.run(
                        "kv_h2d", lambda: self._h2d(buf, nbytes),
                        health=self.health)
                finally:
                    self._done_reading(h, buf, src, nbytes)
                t1 = clock()
            except (KeyboardInterrupt, SystemExit):
                # control flow: unblock waiters, then die loudly
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
            if src == "disk":
                # staged on the device now: drop the disk copy and its
                # disk-tier lease
                with self._cv:
                    disk_nb = self._disk_keys.pop(h, 0)
                self.disk.drop(h)
                self.memory.release("disk", disk_nb, self.owner)
                self.fetched_disk_pages += 1
            self.tracer.span_event(f"kv_h2d[{h}]", t0, t1, cat="kv",
                                   track="kv-offloader", nbytes=nbytes)
            with self._cv:
                self._staged[h] = (dev, specs, event)
                self.events.append(PrefetchEvent(0, t0, t1, nbytes))
                self.fetched_bytes += nbytes
                self._cv.notify_all()

    def _done_reading(self, h, buf: torch.Tensor, src: str,
                      nbytes: int) -> None:
        """The worker's copy out of ``buf`` has ended (``_h2d`` waits for
        it) or failed: hand back a disk recall's transient buffer and host
        lease, or a host copy that was spilled while the copy read it."""
        if src == "disk":
            self.pages.give(buf)
            self.memory.release("host", nbytes, self.owner)
            return
        with self._cv:
            if self._reading.pop(h):
                self.pages.give(buf)

    # -- eviction side ----------------------------------------------------- #

    def _spill_one_locked(self) -> bool:
        """Demote the oldest host page to the disk tier to make room.
        Returns False when there is nothing to spill or no disk store.

        Pages whose fetch is pending go last: the fetch reads them, and
        only when every host page is pending does one move (then the
        worker reads it from disk, or ``get`` drops the disk copy of a
        page it staged from the host). A buffer the worker is copying out
        of is handed back by the worker when that copy ends, never here."""
        if self.disk is None or not self._host:
            return False
        key = next((k for k in self._host if k not in self._pending),
                   next(iter(self._host)))
        buf, specs, nbytes = self._host[key]
        # claim disk capacity first (refusal -> BudgetExceeded before any
        # bytes move), then write; roll the move back if the write fails
        self.memory.move("host", "disk", nbytes, self.owner)
        try:
            self.disk.put_flat(key, buf, specs)   # op kv_d2disk
        except BaseException:
            self.memory.move("disk", "host", nbytes, self.owner)
            raise
        del self._host[key]
        if key in self._reading:
            self._reading[key] = True
        else:
            self.pages.give(buf)
        self._disk_keys[key] = nbytes
        self.spilled_pages += 1
        return True

    def offload(self, h, tree: Tree) -> None:
        """Copy page ``h``'s bytes (``tree``: its leaves, e.g. views of
        the pool on the device) to a leased host buffer; returns once the
        copy is complete."""
        if self.quant:                    # quantize-on-write: host/disk
            tree = quantize_page(tree)    # hold the int8 + scale bytes
        specs = page_layout(tree)
        nbytes = layout_nbytes(specs)

        def put() -> torch.Tensor:
            if self.injector is not None:
                self.injector.check("kv_d2h")
            # enforce the host budget: spill cold pages to disk until the
            # lease fits; a refusal with no disk room left surfaces as
            # BudgetExceeded (transient under the policy)
            with self._cv:
                while not self.memory.try_lease("host", nbytes, self.owner):
                    if not self._spill_one_locked():
                        st = self.memory.stats()["host"]
                        raise BudgetExceeded(
                            f"KV offload of {nbytes} B refused: host "
                            f"tier {st.used}/{st.capacity} B used and "
                            f"no disk tier to spill to",
                            tier="host", requested=nbytes, used=st.used,
                            capacity=st.capacity or 0)
            try:
                return _to_host(self.pages, tree, specs,
                                self.copy_events["d2h"])
            except BaseException:
                self.memory.release("host", nbytes, self.owner)
                raise

        t0 = clock()
        buf = self.policy.run("kv_d2h", put, health=self.health)
        self.tracer.span_event(f"kv_d2h[{h}]", t0, clock(), cat="kv",
                               track="kv-offloader", nbytes=nbytes)
        with self._cv:
            self._host[h] = (buf, specs, nbytes)
            self.offloaded_bytes += nbytes

    def holds(self, h) -> bool:
        with self._cv:
            return h in self._host or h in self._disk_keys

    # -- fetch side (consumer) -------------------------------------------- #

    def schedule(self, h) -> None:
        with self._cv:
            if h in self._pending:
                return
            self._pending.add(h)
            self._queue.append(h)
            self._cv.notify_all()

    def get(self, h, *, timeout: Optional[float] = None) -> Tree:
        """Block until page ``h`` is staged (at most ``timeout`` seconds,
        default the policy's ``get_timeout_s``); returns its tree on the
        device, ready for the compute stream (which waits on the copy)."""
        if timeout is None:
            timeout = self.policy.get_timeout_s
        t_enter = clock()
        deadline = t_enter + timeout
        with self.tracer.phase("h2d", cat="kv", track="decode",
                               min_dur=2e-4, label=f"kv_wait[{h}]"):
            with self._cv:
                while h not in self._staged:
                    if self._error is not None:
                        raise RuntimeError(
                            f"offload fetch of page hash {h} failed "
                            f"({self.health.report()})") from self._error
                    if self._stop:
                        raise RuntimeError(
                            "offloader stopped" + (
                                " (worker interrupted)"
                                if self._interrupted else ""))
                    remaining = deadline - clock()
                    if remaining <= 0:
                        self.health.stalled = True
                        raise StallTimeout(
                            f"offloaded page not staged within "
                            f"{timeout:.1f}s ({self.health.report()})",
                            op="kv_h2d")
                    self._cv.wait(min(remaining, 0.25))
                dev, specs, event = self._staged.pop(h)
                self._pending.discard(h)
                ent = self._host.pop(h, None)   # back on the device
                if ent is not None:             # host copy done: unlease
                    self.memory.release("host", ent[2], self.owner)
                    self.pages.give(ent[0])
                disk_nb = self._disk_keys.pop(h, None)
                if disk_nb is not None:         # spilled after staging
                    self.disk.drop(h)
                    self.memory.release("disk", disk_nb, self.owner)
                self.stall_s += clock() - t_enter
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            dev.record_stream(stream)
        tree = page_tree(dev, specs)
        if is_quantized_page(tree):       # dequantize-on-read (lossy tier)
            tree = dequantize_page(tree, self.page_dtype)
        return tree

    def stats(self) -> PrefetchStats:
        """Uniform ``PrefetchStats`` view — the surface the layer
        prefetcher exposes, so stall and retry counters read alike."""
        with self._cv:
            events = list(self.events)
            fetched = self.fetched_bytes
        return PrefetchStats(
            events=events, peak_resident_bytes=0,
            total_bytes_read=fetched, stall_s=self.stall_s,
            layers_served=len(events), releases=0,
            retries=self.health.retries,
            budget_refusals=sum(s.refusals
                                for s in self.memory.stats().values()))

    def copy_device_ms(self, kind: str) -> List[float]:
        """Milliseconds between the CUDA events around each kept ``"d2h"``
        or ``"h2d"`` page copy (empty off the card). The H2D pair sits on
        the worker's idle side stream, so a wait of the worker between
        the two events (for the interpreter lock) is in it too."""
        out = []
        for start, end in list(self.copy_events[kind]):
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def close(self, timeout: float = 5.0) -> bool:
        """Stop the worker (idempotent); True once it has joined, False
        with a logged stall report if it is stuck. Host copies hand their
        leases back so a shared budget balances after shutdown."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self.health.stalled = True
            log.error("BlockOffloader.close: worker failed to join "
                      "within %.1fs — %s", timeout, self.health.report())
            return False
        with self._cv:
            for h in list(self._host):
                buf, _, nbytes = self._host.pop(h)
                self.memory.release("host", nbytes, self.owner)
                self.pages.give(buf)
            for h in list(self._disk_keys):
                self.memory.release("disk", self._disk_keys.pop(h),
                                    self.owner)
            self._staged.clear()
            self._pending.clear()
        self.health.closed = True
        return True


# --------------------------------------------------------------------------- #
#  paged cache manager
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class KVStats:
    """Allocator + traffic view of a paged-cache run."""

    n_pages: int
    page_tokens: int
    page_bytes: int                   # one page across all layers/leaves
    active_pages_highwater: int       # max simultaneously-referenced pages
    active_tokens_highwater: int      # max live tokens across slots
    prefix_hits: int                  # pages obtained by key match
    cow_copies: int
    evictions: int
    offloaded_bytes: int = 0
    fetched_bytes: int = 0
    fetch_events: List[PrefetchEvent] = dataclasses.field(
        default_factory=list)
    fetch_stall_s: float = 0.0        # admits blocked on a staging fetch
    fetch_retries: int = 0            # transient I/O retries (IOPolicy)
    disk_bytes_written: int = 0       # kv_d2disk traffic (spills + parks)
    disk_bytes_read: int = 0          # kv_disk2h traffic (recalls)
    spilled_pages: int = 0            # host pages demoted to disk
    fetched_disk_pages: int = 0       # prefix recalls served from disk
    parked_sessions: int = 0          # lifetime park count
    restored_sessions: int = 0        # lifetime restore count
    budget_refusals: int = 0          # tier leases the budget refused

    @property
    def highwater_bytes(self) -> int:
        return self.active_pages_highwater * self.page_bytes

    def dense_bytes(self, batch: int, max_len: int) -> int:
        """What the dense (L, B, max_len, ...) preallocation would hold."""
        return int(batch * max_len * self.page_bytes
                   / max(self.page_tokens, 1))


def paged_cache_spec(cfg) -> Dict[str, Tuple[int, ...]]:
    """Per-leaf trailing shapes of one cache line (one token, one layer):
    K/V (and int8 scales), or MLA's latent line."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"paged KV cache unsupported for family {cfg.family} "
            "(recurrent state has no per-token pages)")
    if cfg.mla:
        if cfg.kv_dtype == "int8":
            raise NotImplementedError(
                "paged MLA latent storage does not support int8 "
                "quantization (the latent is already compressed)")
        return {"latent": (cfg.kv_lora_rank + cfg.qk_rope_dim,)}
    hk, hd = max(cfg.kv_heads, 1), cfg.head_dim
    if cfg.kv_dtype == "int8":
        # int8 K/V plus per-(position, kv-head) scales in the pool dtype
        return {"k": (hk, hd), "v": (hk, hd),
                "k_scale": (hk,), "v_scale": (hk,)}
    return {"k": (hk, hd), "v": (hk, hd)}


def paged_leaf_dtype(name: str, cfg, pool_dtype):
    """Storage dtype of a paged leaf: int8 for quantized K/V, the pool
    dtype for everything else (scales included)."""
    if cfg.kv_dtype == "int8" and name in ("k", "v"):
        return torch.int8
    return pool_dtype


@dataclasses.dataclass
class ParkedSession:
    """A session's KV lifted off the device tier between requests.

    ``tier == "host"``: ``pages`` holds (host buffer, layout) per page.
    ``tier == "disk"``: the pages live in per-session :class:`PageFileStore`
    files (keys ``("sess", session, j)``) and ``pages`` is None. ``meta``
    is an opaque engine blob (the resume token) returned verbatim on
    restore.
    """

    session: str
    length: int
    n_pages: int
    nbytes: int
    tier: str
    pages: Optional[List[Tuple[torch.Tensor, List[LeafSpec]]]]
    meta: dict
    parked_t: float


class PagedKVCache:
    """Owner of the block pool + per-slot page lists for a serving batch.

    cache = {
      "pages":       {leaf: (L, P, page_tokens, ...)}  (written in place),
      "block_table": (B, max_pages_per_slot) int32,
      "len":         (B,) int32,
    }

    The whole pool leases from ``memory``'s ``device`` tier at
    construction (``n_pages=None`` derives the pool size from the device
    budget); ``offload`` (the default) keeps evicted prefix pages in a
    ``BlockOffloader`` whose host copies lease from ``host``; ``disk_dir``
    adds the disk tier (spilled prefix pages and parked sessions);
    ``park_idle_s`` enables session parking (``park_session``, demoted to
    disk by ``sweep_parked`` after that many idle seconds,
    ``restore_session``). ``evict_policy="cost"`` evicts at the least
    modeled recall loss (``recall_costs``, default
    ``core.latency.kv_recall_costs(page_bytes)``).
    """

    def __init__(self, cfg, *, batch: int, ctx: int,
                 n_pages: Optional[int] = None, page_tokens: int = 16,
                 dtype=torch.float32, offload: bool = True,
                 io_policy: Optional[IOPolicy] = None, injector=None,
                 tracer=None, memory: Optional[TierManager] = None,
                 evict_policy: str = "lru", offload_quant: bool = False,
                 disk_dir: Optional[str] = None,
                 park_idle_s: Optional[float] = None,
                 recall_costs=None, device="cuda"):
        self.cfg = cfg
        self.B = batch
        self.page_tokens = page_tokens
        self.max_pages = -(-ctx // page_tokens)
        self.ctx = self.max_pages * page_tokens
        self._spec = paged_cache_spec(cfg)
        self.dtype = dtype
        self.device = torch.device(device)
        self.memory = memory if memory is not None \
            else TierManager(tracer=tracer, name="kv-memory")
        if n_pages is None:
            avail = self.memory.available("device")
            if avail is None:
                raise ValueError(
                    "n_pages omitted: pass a memory manager with a "
                    "device budget to derive the pool size from it")
            n_pages = max(int(avail // max(self.page_bytes, 1)), 2)
        self.recall_costs = recall_costs if recall_costs is not None \
            else kv_recall_costs(self.page_bytes)
        self.pool = BlockPool(
            n_pages, page_tokens, evict_policy=evict_policy,
            recall_cost_fn=self._recall_cost
            if evict_policy == "cost" else None)
        # the pool is one fixed device allocation: lease it whole
        # (construction fails loudly if the budget cannot hold it)
        self._pool_lease = n_pages * self.page_bytes
        self.memory.lease("device", self._pool_lease, "kv")
        self._host_pages = HostPages(pin=self.device.type == "cuda")
        self.disk = PageFileStore(disk_dir, policy=io_policy,
                                  injector=injector, tracer=tracer) \
            if disk_dir else None
        self.offloader = BlockOffloader(
            policy=io_policy, injector=injector, tracer=tracer,
            memory=self.memory, disk=self.disk, quant=offload_quant,
            page_dtype=dtype, device=self.device,
            pages=self._host_pages) if offload else None
        self.park_idle_s = park_idle_s
        self._parked: Dict[str, ParkedSession] = {}
        self.parked_count = 0
        self.restored_count = 0
        self._slot_pages: List[List[int]] = [[] for _ in range(batch)]
        self._len = [0] * batch
        #: worst-case page budget reserved per live slot: with
        #: sum(reserved) <= usable pages, per-step growth and CoW always
        #: succeed, so exhaustion is an admit-time signal only
        self._reserved = [0] * batch
        self._usable = n_pages - 1
        self._dirty = set(range(batch))          # table rows to (re)write
        #: host mirror of the device block table (only ``_sync_tables``
        #: writes either)
        self._table = np.full((batch, self.max_pages), SINK_PAGE, np.int32)
        #: slot -> [(page kind, content key)] for the admit in flight
        #: ("shared" | "fetched" | "fresh")
        self._admit_meta: Dict[int, List[Tuple[str, Any]]] = {}
        #: slots mid chunked admission: their device table row stays all
        #: sink; chunk steps address the pages through ``chunk_table``
        self._chunking: set = set()
        self._active_pages_hw = 0
        self._active_tokens_hw = 0
        self.prefix_hits = 0
        self.cow_copies = 0

    # -- construction ------------------------------------------------------ #

    def init_cache(self) -> Dict[str, Any]:
        L = self.cfg.n_layers
        P, bs = self.pool.n_pages, self.page_tokens
        pages = {name: torch.zeros((L, P, bs) + trail,
                                   dtype=paged_leaf_dtype(name, self.cfg,
                                                          self.dtype),
                                   device=self.device)
                 for name, trail in self._spec.items()}
        held = sum(t.numel() * t.element_size() for t in pages.values())
        if held != P * self.page_bytes:
            raise RuntimeError(
                f"the page pool holds {held} B but leases "
                f"{P * self.page_bytes} B from the device tier")
        return {"pages": pages,
                "block_table": torch.zeros((self.B, self.max_pages),
                                           dtype=torch.int32,
                                           device=self.device),
                "len": torch.zeros((self.B,), dtype=torch.int32,
                                   device=self.device)}

    @property
    def page_bytes(self) -> int:
        L, bs = self.cfg.n_layers, self.page_tokens
        return sum(
            L * bs * int(np.prod(trail, dtype=np.int64))
            * torch.empty((), dtype=paged_leaf_dtype(name, self.cfg,
                                                     self.dtype)
                          ).element_size()
            for name, trail in self._spec.items())

    # -- stats ------------------------------------------------------------- #

    def _note_highwater(self) -> None:
        self._active_pages_hw = max(self._active_pages_hw,
                                    self.pool.n_active)
        self._active_tokens_hw = max(self._active_tokens_hw, sum(self._len))

    def stats(self) -> KVStats:
        off = self.offloader
        return KVStats(
            n_pages=self.pool.n_pages, page_tokens=self.page_tokens,
            page_bytes=self.page_bytes,
            active_pages_highwater=self._active_pages_hw,
            active_tokens_highwater=self._active_tokens_hw,
            prefix_hits=self.prefix_hits, cow_copies=self.cow_copies,
            evictions=self.pool.evictions,
            offloaded_bytes=off.offloaded_bytes if off else 0,
            fetched_bytes=off.fetched_bytes if off else 0,
            fetch_events=list(off.events) if off else [],
            fetch_stall_s=off.stall_s if off else 0.0,
            fetch_retries=off.health.retries if off else 0,
            # ``is not None``: an empty (or closed) store is falsy
            disk_bytes_written=self.disk.written_bytes
            if self.disk is not None else 0,
            disk_bytes_read=self.disk.read_bytes
            if self.disk is not None else 0,
            spilled_pages=off.spilled_pages if off else 0,
            fetched_disk_pages=off.fetched_disk_pages if off else 0,
            parked_sessions=self.parked_count,
            restored_sessions=self.restored_count,
            budget_refusals=sum(
                s.refusals for s in self.memory.stats().values()))

    # -- cost-model eviction pricing --------------------------------------- #

    def _recall_cost(self, h) -> float:
        """Modeled seconds to recall page ``h`` if evicted now: the
        ``kv_recall_costs`` term of the tier eviction would land it in
        (host normally; disk when it already lives there or the host
        tier has no room left)."""
        if self.offloader is None:
            return self.recall_costs.disk_s      # content would be lost
        if self.disk is not None:
            if self.disk.holds(h):
                return self.recall_costs.disk_s
            avail = self.memory.available("host")
            if avail is not None and avail < self.page_bytes:
                return self.recall_costs.disk_s  # eviction would spill
        return self.recall_costs.host_s

    # -- page content ops (in place on the cache's pool) ------------------- #

    def _evict_cb(self, cache):
        """Eviction hook: offload the page's bytes to host before reuse."""
        if self.offloader is None:
            return None

        def cb(pid, h):
            self.offloader.offload(
                h, {name: arr[:, pid] for name, arr in cache["pages"].items()})
        return cb

    def _page(self, cache, pid: int) -> Tree:
        """Page ``pid``'s leaves, as views of the pool."""
        return {name: arr[:, pid] for name, arr in cache["pages"].items()}

    def _copy_page(self, cache, src: int, dst: int):
        for arr in cache["pages"].values():
            arr[:, dst] = arr[:, src]
        return cache

    def _scatter_pages(self, cache, pids: List[int], trees: List[Tree]):
        """Write page contents (``trees[i]``: {leaf: (L, bs, ...)} on the
        pool's device) into pool positions ``pids`` — one batched write
        per leaf."""
        if not pids:
            return cache
        idx = torch.as_tensor(pids, dtype=torch.long, device=self.device)
        for name, arr in cache["pages"].items():
            arr[:, idx] = torch.stack([t[name] for t in trees],
                                      dim=1).to(arr.dtype)
        return cache

    def _sync_tables(self, cache):
        """Write dirty slots' page lists into the host mirror, then the
        mirror and the lengths into the device cache's own tensors, one
        copy each, no read-back: their addresses never change (a graphed
        step reads them). Runs before the decode writes of a step, when
        the host and device lengths agree for every live slot (free and
        mid-chunk slots, which decode into the sink, restart at 0)."""
        if not self._dirty:
            return cache
        for slot in self._dirty:
            row = self._table[slot]
            row[:] = SINK_PAGE
            if slot not in self._chunking:       # mid-chunk: stay masked
                pids = self._slot_pages[slot][:self.max_pages]
                row[:len(pids)] = pids
        self._dirty.clear()
        lens = np.asarray([0 if s in self._chunking else self._len[s]
                           for s in range(self.B)], np.int32)
        _upload(cache["block_table"], self._table)
        _upload(cache["len"], lens)
        return cache

    # -- admit ------------------------------------------------------------- #

    def can_ever_admit(self, prompt_len: int, max_new: int) -> bool:
        """Could this request be admitted into an *empty* pool?"""
        total = prompt_len + max_new
        if total > self.ctx:
            return False
        return -(-total // self.page_tokens) + 1 <= self._usable

    def plan_admit(self, cache, slot: int, prompt: Sequence[int],
                   max_new: int, *, register: bool = True
                   ) -> Dict[str, int]:
        """Reserve pages for a prompt: prefix-share where keys match,
        schedule background fetches for offloaded matches, allocate the
        rest (evicting to host where the pool is full). Runs before the
        prefill compute so the fetches overlap it; ``install`` collects
        them. ``register=False`` defers key registration of fresh pages
        to ``finish_chunked_admit`` (a concurrent admit must not share a
        page whose bytes are not all written yet)."""
        bs = self.page_tokens
        S, total = len(prompt), len(prompt) + max_new
        if total > self.ctx:
            raise ValueError(
                f"request needs {total} positions (prompt {S} + max_new "
                f"{max_new}) but the paged slot addresses only "
                f"{self.ctx} ({self.max_pages} pages x {bs} tokens)")
        if self._slot_pages[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        # worst-case lifetime pages: every position paged, +1 for the CoW
        # clone of a shared divergence page
        worst = -(-total // bs) + 1
        committed = sum(self._reserved) + worst
        if committed > self._usable:
            raise PoolExhausted(
                f"KV block pool exhausted: admitting would oversubscribe "
                f"{committed}/{self._usable} pages "
                f"({sum(1 for r in self._reserved if r)} slots live)")
        pids: List[int] = []
        meta: List[Tuple[str, Any]] = []
        h: tuple = ()
        try:
            for j in range(-(-S // bs)):
                toks = prompt[j * bs:(j + 1) * bs]
                h = chain_key(h, toks, len(toks))
                pid = self.pool.lookup(h)
                if pid is not None:                      # resident hit
                    self.pool.retain(pid)
                    kind = "shared"
                elif self.offloader is not None and self.offloader.holds(h):
                    pid = self.pool.alloc(evict_cb=self._evict_cb(cache))
                    self.offloader.schedule(h)
                    self.pool.register(h, pid)
                    self.pool.note_hit(h)    # off-device reuse
                    kind = "fetched"
                else:
                    pid = self.pool.alloc(evict_cb=self._evict_cb(cache))
                    if register:
                        self.pool.register(h, pid)
                    kind = "fresh"
                pids.append(pid)
                meta.append((kind, h))
        except PoolExhausted:
            # roll the reservation back whole: pages registered for this
            # admit were never filled, so they must not enter the cache
            for pid, (kind, _) in zip(pids, meta):
                if kind != "shared":
                    self.pool.unregister(pid)
                self.pool.release(pid)
            raise
        self.prefix_hits += sum(1 for k, _ in meta if k != "fresh")
        self._slot_pages[slot] = pids
        self._admit_meta[slot] = meta
        self._reserved[slot] = worst
        self._dirty.add(slot)
        return {k: sum(1 for kk, _ in meta if kk == k)
                for k in ("shared", "fetched", "fresh")}

    def abort_admit(self, slot: int) -> None:
        """Undo a ``plan_admit`` whose prefill failed."""
        meta = self._admit_meta.pop(slot, None)
        if meta is None:
            return
        for pid, (kind, _) in zip(self._slot_pages[slot], meta):
            if kind != "shared":
                self.pool.unregister(pid)
            self.pool.release(pid)
        self._slot_pages[slot] = []
        self._reserved[slot] = 0
        self._len[slot] = 0
        self._chunking.discard(slot)
        self._dirty.add(slot)

    def install(self, cache, slot: int, slot_layers: Tree,
                length: int) -> Dict[str, Any]:
        """Scatter a freshly prefilled sequence's KV (leaves
        ``(L, 1, S_cap, ...)`` of a one-sequence dense cache) into its
        pages: prefix-shared pages are skipped, offloaded matches are
        collected from the staging thread here, after the prefill compute
        they overlapped."""
        bs = self.page_tokens
        meta = self._admit_meta.pop(slot)
        pids_w: List[int] = []
        trees: List[Tree] = []
        for j, (pid, (kind, h)) in enumerate(
                zip(self._slot_pages[slot], meta)):
            if kind == "shared":
                continue
            if kind == "fetched":
                pids_w.append(pid)
                trees.append(self.offloader.get(h))
                continue
            blk = {}
            for name, arr in slot_layers.items():
                piece = arr[:, 0, j * bs:(j + 1) * bs]
                if piece.shape[1] < bs:                   # partial page
                    pad = torch.zeros(
                        (piece.shape[0], bs - piece.shape[1])
                        + piece.shape[2:], dtype=piece.dtype,
                        device=piece.device)
                    piece = torch.cat([piece, pad], dim=1)
                blk[name] = piece
            pids_w.append(pid)
            trees.append(blk)
        cache = self._scatter_pages(cache, pids_w, trees)
        self._len[slot] = length
        self._dirty.add(slot)
        cache = self._sync_tables(cache)
        self._note_highwater()
        return cache

    # -- chunked admission (prompt KV computed straight into pages) --------- #

    def begin_chunked_admit(self, cache, slot: int, prompt_len: int
                            ) -> Tuple[Dict[str, Any], int]:
        """Prepare a planned admit (``plan_admit(register=False)``) for
        chunk-direct writes: collect offloaded prefix matches into their
        device pages now (chunk attention reads them), count the leading
        prompt tokens already in shared or fetched pages, and mask the
        slot's device table row (all sink, len 0) so decode steps
        interleaved between chunks cannot write into the half-filled
        pages. Returns ``(cache, skip_tokens)``."""
        meta = self._admit_meta[slot]
        pids_w: List[int] = []
        trees: List[Tree] = []
        for pid, (kind, h) in zip(self._slot_pages[slot], meta):
            if kind == "fetched":
                pids_w.append(pid)
                trees.append(self.offloader.get(h))
        cache = self._scatter_pages(cache, pids_w, trees)
        skip = 0
        for kind, _ in meta:
            if kind == "fresh":
                break
            skip += 1
        skip_tokens = prompt_len if skip >= len(meta) \
            else skip * self.page_tokens
        self._chunking.add(slot)
        self._dirty.add(slot)
        return self._sync_tables(cache), skip_tokens

    def chunk_table(self, slot: int) -> np.ndarray:
        """(1, max_pages) int32 table row for chunk steps of a
        mid-admission slot."""
        row = np.full((1, self.max_pages), SINK_PAGE, np.int32)
        pids = self._slot_pages[slot][:self.max_pages]
        row[0, :len(pids)] = pids
        return row

    def finish_chunked_admit(self, cache, slot: int, length: int
                             ) -> Dict[str, Any]:
        """Register the fresh pages' keys and unmask the slot's row."""
        meta = self._admit_meta.pop(slot)
        for pid, (kind, h) in zip(self._slot_pages[slot], meta):
            if kind == "fresh":
                self.pool.register(h, pid)
        self._chunking.discard(slot)
        self._len[slot] = length
        self._dirty.add(slot)
        cache = self._sync_tables(cache)
        self._note_highwater()
        return cache

    # -- per-step maintenance ---------------------------------------------- #

    def begin_step(self, cache, active: Sequence[int], n_tokens: int
                   ) -> Dict[str, Any]:
        """Make the next ``n_tokens`` positions of every active slot
        writable: grow page lists, copy-on-write shared pages in the write
        range, unregister keys of private pages about to change, and
        flush table/len cleanup of freed slots."""
        bs = self.page_tokens
        for slot in active:
            ln = self._len[slot]
            need = -(-(ln + n_tokens) // bs)
            if need > self.max_pages:
                raise PoolExhausted(
                    f"slot {slot} needs {need} pages (len {ln} + "
                    f"{n_tokens}) > table width {self.max_pages}")
            pids = self._slot_pages[slot]
            while len(pids) < need:
                pids.append(self.pool.alloc(evict_cb=self._evict_cb(cache)))
                self._dirty.add(slot)
            for j in range(ln // bs, (ln + n_tokens - 1) // bs + 1):
                pid = pids[j]
                if self.pool.refcount(pid) > 1:           # divergence: CoW
                    new = self.pool.alloc(evict_cb=self._evict_cb(cache))
                    cache = self._copy_page(cache, pid, new)
                    self.pool.release(pid)
                    pids[j] = new
                    self.cow_copies += 1
                    self._dirty.add(slot)
                else:
                    self.pool.unregister(pid)     # content will change
        cache = self._sync_tables(cache)
        self._note_highwater()
        return cache

    def advance(self, slot: int, n: int = 1) -> None:
        """Commit ``n`` generated tokens."""
        self._len[slot] += n

    def length(self, slot: int) -> int:
        return self._len[slot]

    def trim_to(self, slot: int, new_len: int) -> None:
        """Speculative rollback: free pages past ``new_len`` tokens."""
        keep = -(-new_len // self.page_tokens) if new_len > 0 else 0
        pids = self._slot_pages[slot]
        for pid in pids[keep:]:
            self.pool.release(pid)
        if len(pids) > keep:
            del pids[keep:]
            self._dirty.add(slot)
        self._len[slot] = new_len

    def release_slot(self, slot: int) -> None:
        """Finished sequence: drop its references (keyed prompt pages fall
        into the prefix cache); table cleanup happens at the next sync."""
        for pid in self._slot_pages[slot]:
            self.pool.release(pid)
        self._slot_pages[slot] = []
        self._len[slot] = 0
        self._reserved[slot] = 0
        self._dirty.add(slot)

    # -- session parking (resumable sessions on the host and disk tiers) ---- #

    @property
    def parking(self) -> bool:
        """Whether session parking is configured (``park_idle_s``)."""
        return self.park_idle_s is not None

    def is_parked(self, session: str) -> bool:
        return session in self._parked

    def _session_key(self, session: str, j: int) -> tuple:
        return ("sess", session, j)

    def _drop_session_files(self, session: str, n: int) -> None:
        for j in range(n):
            self.disk.drop(self._session_key(session, j))

    def _give_host_pages(self, pages) -> None:
        for buf, _ in pages:
            self._host_pages.give(buf)

    def park_session(self, cache, slot: int, session: str,
                     meta: dict) -> None:
        """Lift ``slot``'s pages off the device tier under ``session``.

        Copies every page's bytes to leased host buffers (or straight to
        per-session page files when the host tier refuses) and frees the
        device pages — the slot is reusable at once. ``meta`` (the
        engine's resume token) comes back verbatim from
        :meth:`restore_session`. Parking is lossless (never quantized).
        Raises :class:`BudgetExceeded` when neither host nor disk can
        hold the session (the caller drops it instead of overshooting).
        """
        if session in self._parked:      # stale park: a newer request
            self._drop_parked(session)   # supersedes the old KV
        pids = self._slot_pages[slot]
        nbytes = len(pids) * self.page_bytes
        pages = None
        if self.memory.try_lease("host", nbytes, "kv"):
            tier = "host"
            pages = []
            try:
                for pid in pids:
                    tree = self._page(cache, pid)
                    specs = page_layout(tree)
                    pages.append((_to_host(self._host_pages, tree, specs),
                                  specs))
            except BaseException:
                self._give_host_pages(pages)
                self.memory.release("host", nbytes, "kv")
                raise
        else:
            if self.disk is None:
                st = self.memory.stats()["host"]
                raise BudgetExceeded(
                    f"cannot park session {session!r}: host tier "
                    f"{st.used}/{st.capacity} B used and no disk tier",
                    tier="host", requested=nbytes, used=st.used,
                    capacity=st.capacity or 0)
            self.memory.lease("disk", nbytes, "kv")   # BudgetExceeded ok
            try:
                for j, pid in enumerate(pids):
                    self.disk.put(self._session_key(session, j),
                                  self._page(cache, pid))
            except BaseException:
                self.memory.release("disk", nbytes, "kv")
                raise
            tier = "disk"
        self._parked[session] = ParkedSession(
            session=session, length=self._len[slot], n_pages=len(pids),
            nbytes=nbytes, tier=tier, pages=pages, meta=dict(meta),
            parked_t=clock())
        self.parked_count += 1
        self.release_slot(slot)    # device pages free; prompt pages may
        self._note_highwater()     # still serve the prefix cache

    def sweep_parked(self) -> int:
        """Demote host-parked sessions idle for ``park_idle_s`` seconds
        to per-session disk page files; returns sessions demoted. A full
        disk tier leaves a session on host (retried next sweep)."""
        if not self.parking or self.disk is None:
            return 0
        now = clock()
        n = 0
        for ps in self._parked.values():
            if ps.tier != "host" or now - ps.parked_t < self.park_idle_s:
                continue
            try:
                self.memory.move("host", "disk", ps.nbytes, "kv")
            except BudgetExceeded:
                continue                 # disk full: stay on host
            try:
                for j, (buf, specs) in enumerate(ps.pages):
                    self.disk.put_flat(self._session_key(ps.session, j),
                                       buf, specs)
            except BaseException:
                self.memory.move("disk", "host", ps.nbytes, "kv")
                raise
            self._give_host_pages(ps.pages)
            ps.tier = "disk"
            ps.pages = None
            n += 1
        return n

    def restore_session(self, cache, slot: int, session: str, *,
                        max_new: int):
        """Bring a parked session's pages back onto the device into
        ``slot``; returns ``(cache, meta, length)`` with ``meta`` the blob
        ``park_session`` recorded. The restored bytes equal the parked
        bytes (host buffers or page files, both lossless), so decode
        continues exactly where it left off. Raises ``PoolExhausted``
        (the session stays parked) when the pool cannot hold it now."""
        ps = self._parked[session]
        bs = self.page_tokens
        total = ps.length + max_new
        if total > self.ctx:
            raise ValueError(
                f"session {session!r} needs {total} positions "
                f"(parked len {ps.length} + max_new {max_new}) but the "
                f"paged slot addresses only {self.ctx}")
        if self._slot_pages[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        worst = -(-total // bs) + 1
        committed = sum(self._reserved) + worst
        if committed > self._usable:
            raise PoolExhausted(
                f"KV block pool exhausted: restoring session "
                f"{session!r} would oversubscribe "
                f"{committed}/{self._usable} pages")
        pids: List[int] = []
        try:
            for _ in range(ps.n_pages):
                pids.append(self.pool.alloc(evict_cb=self._evict_cb(cache)))
        except PoolExhausted:
            for pid in pids:
                self.pool.release(pid)
            raise                        # still parked; admit defers
        if ps.tier == "host":
            pages = ps.pages
        else:                            # page files into host buffers
            pages = []
            try:
                for j in range(ps.n_pages):
                    key = self._session_key(session, j)
                    buf = self._host_pages.take(self.disk.nbytes(key))
                    pages.append((buf, None))    # handed back on failure
                    pages[-1] = (buf, self.disk.read_into(key, buf))
            except BaseException:        # op kv_disk2h gave up: the
                self._give_host_pages(pages)   # session stays parked
                for pid in pids:
                    self.pool.release(pid)
                raise
        # blocking copies: the host buffers are reused next
        trees = [{n: t.to(self.device) for n, t in page_tree(b, s).items()}
                 for b, s in pages]
        cache = self._scatter_pages(cache, pids, trees)
        self._slot_pages[slot] = pids
        self._len[slot] = ps.length
        self._reserved[slot] = worst
        self._dirty.add(slot)
        cache = self._sync_tables(cache)
        del self._parked[session]
        self.memory.release(ps.tier, ps.nbytes, "kv")
        self._give_host_pages(pages)
        if ps.tier == "disk":
            self._drop_session_files(session, ps.n_pages)
        self.restored_count += 1
        self._note_highwater()
        return cache, ps.meta, ps.length

    def _drop_parked(self, session: str) -> None:
        ps = self._parked.pop(session, None)
        if ps is None:
            return
        self.memory.release(ps.tier, ps.nbytes, "kv")
        if ps.tier == "host":
            self._give_host_pages(ps.pages)
        else:
            self._drop_session_files(session, ps.n_pages)

    def close(self) -> None:
        """Return every lease (parked sessions, host copies, page files,
        the pool); idempotent."""
        for session in list(self._parked):
            self._drop_parked(session)
        if self.offloader is not None:
            self.offloader.close()
        if self.disk is not None:
            self.disk.close()
        self._host_pages.close()
        if self._pool_lease:           # the lease returns once
            self.memory.release("device", self._pool_lease, "kv")
            self._pool_lease = 0


# --------------------------------------------------------------------------- #
#  continuous-batching integration
# --------------------------------------------------------------------------- #

def paged_scrub(cache, T: int = 0):
    """A paged cache's capture scrub: an all-sink table and zero lengths,
    so every write of a step lands on the sink page, whose content is
    saved and restored with the table and lengths."""
    sink = [arr[:, SINK_PAGE] for arr in cache["pages"].values()]
    return saved([cache["block_table"], cache["len"], *sink],
                 zero=[cache["block_table"], cache["len"]])  # SINK_PAGE 0


class GraphedChunk:
    """``chunk_step(view, tokens (1, S), write)`` of chunked admission,
    the counterpart of ``_prefill_chunk_jit``: a full chunk (S =
    ``chunk``) is replayed from a CUDA graph per ``write`` value, its
    table row, start and tokens copied into static buffers; a ragged last
    chunk (and the one-row ``write=False`` re-derivation) runs eagerly.
    ``graphed``/``eager`` count the chunks each way."""

    def __init__(self, fn, graphs: StepGraphs, chunk: int, max_pages: int,
                 device):
        self.fn = fn
        self.graphs = graphs
        self.chunk = chunk
        self.table = torch.full((1, max_pages), SINK_PAGE, dtype=torch.int32,
                                device=device)
        self.len = torch.zeros((1,), dtype=torch.int32, device=device)
        self.tokens: Optional[torch.Tensor] = None
        self._sig = None
        self.graphed = 0
        self.eager = 0

    def __call__(self, view, tokens: torch.Tensor, write: bool = True):
        if tokens.shape[1] != self.chunk:
            self.eager += 1
            return self.fn(view, tokens, write)
        pages = view["pages"]
        sig = tuple(t.data_ptr() for t in cache_tensors(pages))
        if sig != self._sig:
            self.graphs.reset("chunk")
            self._sig = sig
        if self.tokens is None:
            self.tokens = torch.zeros_like(tokens)
        self.table.copy_(view["block_table"])
        self.len.copy_(view["len"])
        self.tokens.copy_(tokens)
        static = {"pages": pages, "block_table": self.table, "len": self.len}
        logits = self.graphs.run(
            ("chunk", write), lambda: self.fn(static, self.tokens, write)[0],
            lambda: paged_scrub(static))
        self.graphed += 1
        return logits, view


def make_paged_engine(params, cfg, batch: int, ctx: int, *,
                      n_pages: Optional[int] = None, page_tokens: int = 16,
                      eos_id: Optional[int] = None, spec=None,
                      offload: bool = True, cache_dtype=torch.float32,
                      io_policy: Optional[IOPolicy] = None, injector=None,
                      tracer=None, memory: Optional[TierManager] = None,
                      evict_policy: str = "lru", offload_quant: bool = False,
                      disk_dir: Optional[str] = None,
                      park_idle_s: Optional[float] = None,
                      prefill_chunk: Optional[int] = None, metrics=None,
                      graphs: bool = True, device="cuda"):
    """Build a ``ContinuousBatcher`` over a paged KV cache; returns
    ``(engine, kv)``. Drive it with ``engine.run(kv.init_cache(), reqs)``.

    The decode step is ``models.decode_step_paged``; ``prefill_chunk``
    admits prompts in page-aligned chunks computed straight into the
    slot's pages (``models.prefill_chunk_paged``), interleaved with decode
    steps for the active slots. None = one-shot dense prefill + install.
    ``spec``: a ``SpeculativeDecoder``; its verify pass is this engine's
    decode step at T = gamma + 1 (set ``spec.verify = engine.decode``),
    which reserves gamma + 1 positions a cycle (copy-on-write of a shared
    last page included) and returns pages past the accepted length.

    ``graphs`` (the default): the decode step (at every T it is called
    with) and the full-size chunk step are replayed from CUDA graphs on
    the card, the counterparts of the JAX package's ``_decode_paged_jit``
    and ``_prefill_chunk_jit`` (``GraphedDecode``, ``GraphedChunk``);
    the one-shot prefill stays eager. ``graphs=False`` runs every step
    eagerly, as a run with ``ops.use_kernels(False)`` on the card must.
    ``tracer``/``metrics``: see ``ContinuousBatcher``.

    The tiers (``PagedKVCache``): ``offload``, ``memory`` (a
    ``TierManager``; ``n_pages=None`` sizes the pool from its device
    budget), ``evict_policy``, ``offload_quant``, ``disk_dir``,
    ``park_idle_s`` (session parking: requests with a ``session``),
    ``io_policy`` and ``injector`` (the retry policy and fault injector
    of every tier copy). Close ``kv`` when done: it returns the leases.
    """
    from ..models import model as M

    kv = PagedKVCache(cfg, batch=batch, ctx=ctx, n_pages=n_pages,
                      page_tokens=page_tokens, dtype=cache_dtype,
                      offload=offload, io_policy=io_policy,
                      injector=injector, tracer=tracer, memory=memory,
                      evict_policy=evict_policy,
                      offload_quant=offload_quant, disk_dir=disk_dir,
                      park_idle_s=park_idle_s, device=device)

    def prefill_one(prompt):
        c1 = M.init_cache(cfg, 1, ctx, dtype=cache_dtype, device=device)
        logits, c1 = M.prefill(params, cfg, prompt, c1)
        return int(torch.argmax(logits[0, -1])), c1

    def decode(cache, tokens):
        return M.decode_step_paged(params, cfg, cache, tokens)

    def chunk_step(view, tokens, write=True):
        return M.prefill_chunk_paged(params, cfg, view, tokens, write=write)

    def write_slot(cache, slot_cache, slot, length):   # paged: kv.install
        raise RuntimeError("paged engine installs via kv, not write_slot")

    if prefill_chunk is not None:
        # chunk boundaries align with page boundaries so fresh pages are
        # filled whole before a future admit may share them
        prefill_chunk = max(prefill_chunk // page_tokens, 1) * page_tokens
    sg = None
    if graphs:
        sg = StepGraphs(device)
        decode = GraphedDecode(decode, sg, paged_scrub)
        if prefill_chunk is not None:
            chunk_step = GraphedChunk(chunk_step, sg, prefill_chunk,
                                      kv.max_pages, device)
    eng = ContinuousBatcher(batch, prefill_one, write_slot, decode,
                            eos_id=eos_id, spec=spec, kv=kv,
                            prefill_chunk=prefill_chunk,
                            chunk_step=chunk_step, tracer=tracer,
                            metrics=metrics, device=device, graphs=sg)
    return eng, kv
