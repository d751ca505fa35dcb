"""Unified tiered memory manager: one budget for weights *and* KV.

A copy of ``repro.runtime.memory``: the port's layer prefetcher leases its
host staging and device bytes from a ``TierManager``. The paged KV pool
and its offload tiers lease from it once they are ported (ROADMAP Queue A
item 4).

The paper's "OOM-free with <6% memory pressure" claim rests on treating
disk, RAM and VRAM as a single coordinated hierarchy. The repo grew
that hierarchy piecewise — weights stream disk→host→device through
``ParamStore``/``LayerPrefetcher`` with a per-subsystem ``window`` cap,
KV pages live in a device ``BlockPool`` with host-only offload — so
nothing enforced a whole-system budget and an idle user's KV could
never leave RAM. This module is the unification (ROADMAP item 3; PIPO's
pipelined host↔device offload timeline and TPI-LLM's sliding-window
memory scheduler in PAPERS.md are the two designs it subsumes):

  * :class:`MemoryBudget` — byte caps for the ``device`` / ``host`` /
    ``disk`` tiers (``None`` = unbounded). One budget object describes
    the whole machine.
  * :class:`TierManager` — the single accountant for every resident
    byte. Subsystems *lease* bytes from a tier before materializing
    them and release (or :meth:`~TierManager.move` across tiers) when
    the bytes move on: the layer prefetchers lease staging/device bytes
    per staged layer, the KV block pool leases its device pool, the
    offloader leases host copies and disk page files. Capacity caps
    stop living inside each subsystem — ``LayerPrefetcher``'s window
    and ``BlockPool``'s page count become *scheduling* parameters while
    the byte ceiling is enforced here, so the whole-system high-water
    can never exceed the configured budget by construction.
  * per-tier, per-owner telemetry: every mutation updates
    :class:`TierStats` (used / peak / lease / release / refusal
    counters) and, with a tracer attached, emits ``mem/<tier>/used``
    counters onto the shared telemetry timeline.

A refused lease raises :class:`~runtime.iopolicy.BudgetExceeded` — an
``OSError`` the shared :class:`~runtime.iopolicy.IOPolicy` classifies
*transient*, because a full tier is usually a tier another slot is
about to make room in; ``wait=True`` leases block (bounded) for that
room instead of failing immediately.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

from .iopolicy import BudgetExceeded
from .telemetry import clock, resolve_tracer

TIERS = ("device", "host", "disk")


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """Byte caps per tier; ``None`` leaves a tier unbounded.

    One instance describes the whole machine the runtime may use:
    ``device`` is the accelerator pool (KV pages + staged device
    layers), ``host`` is pinned RAM (staging buffers + offloaded KV
    copies), ``disk`` bounds page files (parked sessions + spilled
    pages). ``from_mb`` is the CLI-friendly constructor behind
    ``serve --device-budget/--host-budget``.
    """

    device: Optional[int] = None
    host: Optional[int] = None
    disk: Optional[int] = None

    def __post_init__(self):
        for tier in TIERS:
            cap = getattr(self, tier)
            if cap is not None and cap < 0:
                raise ValueError(f"{tier} budget must be >= 0, got {cap}")

    def cap(self, tier: str) -> Optional[int]:
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r} (expected {TIERS})")
        return getattr(self, tier)

    @classmethod
    def from_mb(cls, *, device: Optional[float] = None,
                host: Optional[float] = None,
                disk: Optional[float] = None) -> "MemoryBudget":
        conv = lambda x: None if x is None else int(x * 1e6)
        return cls(device=conv(device), host=conv(host), disk=conv(disk))


@dataclasses.dataclass
class TierStats:
    """Accounting view of one tier (budget audits + benchmarks)."""

    capacity: Optional[int]          # None = unbounded
    used: int = 0
    peak: int = 0                    # high-water of ``used``
    leases: int = 0                  # successful lease calls
    releases: int = 0
    refusals: int = 0                # leases denied (BudgetExceeded)
    leased_bytes: int = 0            # lifetime bytes leased
    released_bytes: int = 0          # lifetime bytes released

    @property
    def available(self) -> Optional[int]:
        return None if self.capacity is None else self.capacity - self.used


class TierManager:
    """Thread-safe accountant of every resident byte across the tiers.

    ``lease(tier, nbytes, owner)`` reserves bytes against the tier's
    cap (raising :class:`BudgetExceeded` on refusal, or blocking up to
    ``timeout`` when ``wait=True``); ``release`` returns them; ``move``
    atomically re-homes bytes (host→device after an H2D copy,
    host→disk after a spill). ``owner`` tags the accounting — "weights"
    vs "kv" — so the unified budget still reports who holds what.

    The manager never touches the bytes themselves: subsystems
    materialize buffers only after their lease succeeds, so the sum of
    live leases is an upper bound on true residency and the per-tier
    high-water (``stats()[tier].peak``) can never exceed the budget.
    """

    def __init__(self, budget: Optional[MemoryBudget] = None, *,
                 tracer=None, name: str = "memory"):
        self.budget = budget or MemoryBudget()
        self.tracer = resolve_tracer(tracer)
        self.name = name
        self._cv = threading.Condition()
        self._stats: Dict[str, TierStats] = {
            t: TierStats(capacity=self.budget.cap(t)) for t in TIERS}
        self._owners: Dict[str, Dict[str, int]] = {t: {} for t in TIERS}

    # -- queries ----------------------------------------------------------- #

    def used(self, tier: str) -> int:
        with self._cv:
            return self._tier(tier).used

    def peak(self, tier: str) -> int:
        with self._cv:
            return self._tier(tier).peak

    def capacity(self, tier: str) -> Optional[int]:
        return self.budget.cap(tier)

    def available(self, tier: str) -> Optional[int]:
        """Free bytes in ``tier`` (None = unbounded)."""
        with self._cv:
            return self._tier(tier).available

    def owner_bytes(self, owner: str, tier: Optional[str] = None) -> int:
        """Bytes ``owner`` currently holds (in one tier or across all)."""
        with self._cv:
            tiers = [tier] if tier is not None else list(TIERS)
            return sum(self._owners[t].get(owner, 0) for t in tiers)

    def stats(self) -> Dict[str, TierStats]:
        with self._cv:
            return {t: dataclasses.replace(s)
                    for t, s in self._stats.items()}

    def _tier(self, tier: str) -> TierStats:
        st = self._stats.get(tier)
        if st is None:
            raise ValueError(f"unknown tier {tier!r} (expected {TIERS})")
        return st

    # -- mutation ---------------------------------------------------------- #

    def _fits_locked(self, tier: str, nbytes: int) -> bool:
        st = self._tier(tier)
        return st.capacity is None or st.used + nbytes <= st.capacity

    def _lease_locked(self, tier: str, nbytes: int, owner: str) -> None:
        st = self._tier(tier)
        st.used += nbytes
        st.peak = max(st.peak, st.used)
        st.leases += 1
        st.leased_bytes += nbytes
        self._owners[tier][owner] = \
            self._owners[tier].get(owner, 0) + nbytes
        self.tracer.counter(f"mem/{tier}/used", st.used, track=self.name)

    def _release_locked(self, tier: str, nbytes: int, owner: str) -> None:
        st = self._tier(tier)
        held = self._owners[tier].get(owner, 0)
        if nbytes > held:
            raise ValueError(
                f"release of {nbytes} B from {tier} by {owner!r}, who "
                f"holds only {held} B — the tier-budget audit would go "
                f"negative (double release?)")
        st.used -= nbytes
        st.releases += 1
        st.released_bytes += nbytes
        left = held - nbytes
        if left:
            self._owners[tier][owner] = left
        else:
            del self._owners[tier][owner]
        self.tracer.counter(f"mem/{tier}/used", st.used, track=self.name)

    def try_lease(self, tier: str, nbytes: int,
                  owner: str = "anon") -> bool:
        """Non-blocking lease; False (and a counted refusal) on a full
        tier instead of an exception."""
        if nbytes < 0:
            raise ValueError(f"lease of negative bytes: {nbytes}")
        with self._cv:
            if not self._fits_locked(tier, nbytes):
                self._tier(tier).refusals += 1
                return False
            self._lease_locked(tier, nbytes, owner)
            return True

    def lease(self, tier: str, nbytes: int, owner: str = "anon", *,
              wait: bool = False, timeout: float = 30.0,
              cancelled: Optional[Callable[[], bool]] = None) -> None:
        """Reserve ``nbytes`` in ``tier`` or raise :class:`BudgetExceeded`.

        ``wait=True`` blocks (up to ``timeout`` seconds, waking on every
        release) for another holder to make room — the backpressure mode
        worker threads use so a full tier throttles staging instead of
        failing it. ``cancelled`` lets a waiting worker abandon the
        lease when its owner is shutting down.
        """
        if nbytes < 0:
            raise ValueError(f"lease of negative bytes: {nbytes}")
        deadline = clock() + timeout
        with self._cv:
            while not self._fits_locked(tier, nbytes):
                st = self._tier(tier)
                if not wait or (cancelled is not None and cancelled()):
                    st.refusals += 1
                    raise BudgetExceeded(
                        f"{self.name}: {tier} tier refuses {nbytes} B "
                        f"({st.used}/{st.capacity} B used)",
                        tier=tier, requested=nbytes, used=st.used,
                        capacity=st.capacity or 0)
                remaining = deadline - clock()
                if remaining <= 0:
                    st.refusals += 1
                    raise BudgetExceeded(
                        f"{self.name}: {tier} tier still refuses "
                        f"{nbytes} B after {timeout:.1f}s "
                        f"({st.used}/{st.capacity} B used)",
                        tier=tier, requested=nbytes, used=st.used,
                        capacity=st.capacity or 0)
                self._cv.wait(min(remaining, 0.25))
            self._lease_locked(tier, nbytes, owner)

    def release(self, tier: str, nbytes: int, owner: str = "anon") -> None:
        """Return ``nbytes`` to ``tier`` and wake blocked leases."""
        if nbytes < 0:
            raise ValueError(f"release of negative bytes: {nbytes}")
        with self._cv:
            self._release_locked(tier, nbytes, owner)
            self._cv.notify_all()

    def resize(self, tier: str, owner: str, old: int, new: int) -> None:
        """Adjust a live lease to its true size (an upper-bound lease —
        e.g. ``layer_nbytes`` before a quantized store read — shrinks to
        the packed bytes actually staged)."""
        if new > old:
            self.lease(tier, new - old, owner)
        elif new < old:
            self.release(tier, old - new, owner)

    def move(self, src: str, dst: str, nbytes: int,
             owner: str = "anon", *, wait: bool = False,
             timeout: float = 30.0,
             cancelled: Optional[Callable[[], bool]] = None) -> None:
        """Atomically re-home ``nbytes`` from ``src`` to ``dst`` (the
        copy already happened — host→device after an H2D ``device_put``,
        host→disk after a page spill). The destination must fit (same
        wait/refusal semantics as :meth:`lease`); the source release
        only lands once it does, so an audit never sees the bytes in
        zero or two tiers."""
        if src == dst:
            return
        deadline = clock() + timeout
        with self._cv:
            while not self._fits_locked(dst, nbytes):
                st = self._tier(dst)
                if not wait or (cancelled is not None and cancelled()):
                    st.refusals += 1
                    raise BudgetExceeded(
                        f"{self.name}: cannot move {nbytes} B "
                        f"{src}->{dst}: {dst} tier full "
                        f"({st.used}/{st.capacity} B used)",
                        tier=dst, requested=nbytes, used=st.used,
                        capacity=st.capacity or 0)
                remaining = deadline - clock()
                if remaining <= 0:
                    st.refusals += 1
                    raise BudgetExceeded(
                        f"{self.name}: move {src}->{dst} of {nbytes} B "
                        f"still refused after {timeout:.1f}s "
                        f"({st.used}/{st.capacity} B used)",
                        tier=dst, requested=nbytes, used=st.used,
                        capacity=st.capacity or 0)
                self._cv.wait(min(remaining, 0.25))
            self._release_locked(src, nbytes, owner)
            self._lease_locked(dst, nbytes, owner)
            self._cv.notify_all()

    # -- invariants (tests / benchmarks) ----------------------------------- #

    def audit(self) -> None:
        """Assert the books balance: per-owner bytes sum to each tier's
        ``used``, nothing is negative, and no tier exceeds its cap."""
        with self._cv:
            for tier, st in self._stats.items():
                owned = sum(self._owners[tier].values())
                assert st.used == owned, \
                    f"{tier}: used {st.used} != sum(owners) {owned}"
                assert st.used >= 0, f"{tier}: negative used {st.used}"
                assert st.leased_bytes - st.released_bytes == st.used, \
                    (f"{tier}: lifetime leases {st.leased_bytes} - "
                     f"releases {st.released_bytes} != used {st.used}")
                if st.capacity is not None:
                    assert st.peak <= st.capacity, \
                        f"{tier}: peak {st.peak} > cap {st.capacity}"

    def report(self) -> str:
        with self._cv:
            parts = []
            for tier, st in self._stats.items():
                cap = "inf" if st.capacity is None \
                    else f"{st.capacity / 1e6:.1f}"
                parts.append(
                    f"{tier} {st.used / 1e6:.1f}/{cap} MB "
                    f"(peak {st.peak / 1e6:.1f}, "
                    f"{st.refusals} refusals)")
            return f"{self.name}: " + ", ".join(parts)
