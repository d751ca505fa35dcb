"""Paged KV cache of the port: block-pool allocator, prefix reuse,
copy-on-write, and the paged continuous-batching engine.

Counterpart of ``repro.runtime.kvcache`` with a torch page pool:

  * ``BlockPool`` — fixed-size token pages with refcounts; refcount-0
    pages stay content-addressed as an LRU prefix cache;
  * prefix reuse — every full prompt page (and the final partial page) is
    keyed by its exact chained token key (compared by value, so a
    collision never shares the wrong bytes); writes into a shared page
    copy-on-write at the divergence page;
  * ``PagedKVCache`` — per-slot page lists, admission with worst-case
    page reservation, chunked admission, and the device block table.

Device state lives in the engine-threaded cache dict
(``{"pages", "block_table", "len"}``). Page contents are written in place.
Host offload, the disk tier, session parking, ``TierManager`` leasing and
cost-model eviction are not ported yet (ROADMAP Queue A item 4).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .engine import (ContinuousBatcher, GraphedDecode, StepGraphs,
                     cache_tensors, saved)

#: page id 0 is a write sink: freed slots keep decoding junk into it (the
#: batch is fixed-width, inactive rows still run), so it is never handed
#: out by the allocator and its content is never read unmasked.
SINK_PAGE = 0

_TIERS_ITEM = ("host offload, the disk tier, session parking and "
               "budget-derived pool sizes are not ported yet "
               "(ROADMAP Queue A item 4)")


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
    """Refcounted fixed-size page allocator with an LRU prefix cache.

    Page states: free (on the free list), active (refcount >= 1), cached
    (refcount 0 but still content-addressable; evicted LRU-first when the
    free list runs dry — without offload an evicted page's bytes are
    simply dropped). ``release`` of a non-active page raises.
    """

    def __init__(self, n_pages: int, page_tokens: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the write sink)")
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self._free: List[int] = list(range(n_pages - 1, SINK_PAGE, -1))
        self._ref: Dict[int, int] = {}
        self._hash_of: Dict[int, Any] = {}       # pid -> registered key
        self._pid_of: Dict[Any, int] = {}        # content key -> pid
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU, ref 0
        self.alloc_count = 0
        self.evictions = 0

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def lookup(self, h) -> Optional[int]:
        """Device page registered under content key ``h`` (or None)."""
        return self._pid_of.get(h)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return len(self._ref)

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    def alloc(self) -> int:
        """Take a page (refcount 1), evicting the LRU cached page when the
        free list is empty; raises ``PoolExhausted`` when neither has one."""
        if self._free:
            pid = self._free.pop()
        elif self._cached:
            pid = next(iter(self._cached))
            del self._cached[pid]
            del self._pid_of[self._hash_of.pop(pid)]
            self.evictions += 1
        else:
            raise PoolExhausted(
                f"KV block pool exhausted: {self.n_pages - 1} pages, "
                f"{self.n_active} active, none cached/free")
        self._ref[pid] = 1
        self.alloc_count += 1
        return pid

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
#  paged cache manager
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class KVStats:
    """Allocator view of a paged-cache run."""

    n_pages: int
    page_tokens: int
    page_bytes: int                   # one page across all layers/leaves
    active_pages_highwater: int       # max simultaneously-referenced pages
    active_tokens_highwater: int      # max live tokens across slots
    prefix_hits: int                  # pages obtained by key match
    cow_copies: int
    evictions: int

    @property
    def highwater_bytes(self) -> int:
        return self.active_pages_highwater * self.page_bytes

    def dense_bytes(self, batch: int, max_len: int) -> int:
        """What the dense (L, B, max_len, ...) preallocation would hold."""
        return int(batch * max_len * self.page_bytes
                   / max(self.page_tokens, 1))


def paged_cache_spec(cfg) -> Dict[str, Tuple[int, ...]]:
    """Per-leaf trailing shapes of one cache line (one token, one layer)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"paged KV cache unsupported for family {cfg.family} "
            "(recurrent state has no per-token pages)")
    if cfg.family != "dense" or cfg.mla:
        raise NotImplementedError(
            f"the port's paged cache serves the dense GQA family only "
            f"(got {cfg.name})")
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


class PagedKVCache:
    """Owner of the block pool + per-slot page lists for a serving batch.

    cache = {
      "pages":       {leaf: (L, P, page_tokens, ...)}  (written in place),
      "block_table": (B, max_pages_per_slot) int32,
      "len":         (B,) int32,
    }
    """

    def __init__(self, cfg, *, batch: int, ctx: int,
                 n_pages: Optional[int] = None, page_tokens: int = 16,
                 dtype=torch.float32, offload: bool = False,
                 device="cuda"):
        if offload or n_pages is None:
            raise NotImplementedError(_TIERS_ITEM)
        self.cfg = cfg
        self.B = batch
        self.page_tokens = page_tokens
        self.max_pages = -(-ctx // page_tokens)
        self.ctx = self.max_pages * page_tokens
        self._spec = paged_cache_spec(cfg)
        self.dtype = dtype
        self.device = torch.device(device)
        self.pool = BlockPool(n_pages, page_tokens)
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
        return KVStats(
            n_pages=self.pool.n_pages, page_tokens=self.page_tokens,
            page_bytes=self.page_bytes,
            active_pages_highwater=self._active_pages_hw,
            active_tokens_highwater=self._active_tokens_hw,
            prefix_hits=self.prefix_hits, cow_copies=self.cow_copies,
            evictions=self.pool.evictions)

    # -- page content ops (in place on the cache's pool) ------------------- #

    def _copy_page(self, cache, src: int, dst: int):
        for arr in cache["pages"].values():
            arr[:, dst] = arr[:, src]
        return cache

    def _scatter_pages(self, cache, pids: List[int],
                       trees: List[Dict[str, torch.Tensor]]):
        """Write page contents (``trees[i]``: {leaf: (L, bs, ...)}) into
        pool positions ``pids`` — one batched write per leaf."""
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
        allocate the rest. ``register=False`` defers key registration of
        fresh pages to ``finish_chunked_admit`` (a concurrent admit must
        not share a page whose bytes are not all written yet)."""
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
                if pid is not None:
                    self.pool.retain(pid)
                    kind = "shared"
                else:
                    pid = self.pool.alloc()
                    if register:
                        self.pool.register(h, pid)
                    kind = "fresh"
                pids.append(pid)
                meta.append((kind, h))
        except PoolExhausted:
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
                for k in ("shared", "fresh")}

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

    def install(self, cache, slot: int, slot_layers: Dict[str, torch.Tensor],
                length: int) -> Dict[str, Any]:
        """Scatter a freshly prefilled sequence's KV (leaves
        ``(L, 1, S_cap, ...)`` of a one-sequence dense cache) into its
        pages, skipping prefix-shared pages."""
        bs = self.page_tokens
        meta = self._admit_meta.pop(slot)
        pids_w: List[int] = []
        trees: List[Dict[str, torch.Tensor]] = []
        for j, (pid, (kind, _)) in enumerate(
                zip(self._slot_pages[slot], meta)):
            if kind == "shared":
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
        chunk-direct writes: count the leading prompt tokens already in
        shared pages and mask the slot's device table row (all sink,
        len 0) so decode steps interleaved between chunks cannot write
        into the half-filled pages. Returns ``(cache, skip_tokens)``."""
        meta = self._admit_meta[slot]
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
                pids.append(self.pool.alloc())
                self._dirty.add(slot)
            for j in range(ln // bs, (ln + n_tokens - 1) // bs + 1):
                pid = pids[j]
                if self.pool.refcount(pid) > 1:           # divergence: CoW
                    new = self.pool.alloc()
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
                      cache_dtype=torch.float32, offload: bool = False,
                      prefill_chunk: Optional[int] = None, tracer=None,
                      metrics=None, graphs: bool = True, device="cuda"):
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
    """
    from ..models import model as M

    kv = PagedKVCache(cfg, batch=batch, ctx=ctx, n_pages=n_pages,
                      page_tokens=page_tokens, dtype=cache_dtype,
                      offload=offload, device=device)

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
