"""Deterministic, schedule-driven fault injection for the runtime.

A copy of ``repro.runtime.faults`` (standard library only) over the
port's ``iopolicy`` and ``telemetry``, so a chaos run of the port fires on
exactly the calls the JAX package's would.

Chaos testing the streaming runtime needs failures that are (a) the
*right* failures — transient disk errors, short reads, stalls, dead
stages — and (b) exactly reproducible, so a chaos test that passes
today fails tomorrow only if the code regressed, never because the dice
rolled differently. The injector here is therefore schedule-driven and
seeded: each :class:`FaultSpec` names an op kind (``layer_read``,
``kv_h2d``, ``kv_d2h``, ``kv_d2disk``, ``kv_disk2h``), an activation
window (fire after the N-th call, up to ``times`` firings, ``times=-1``
for a permanent fault), and a mode:

  * ``error``       — raise ``error_type`` (default :class:`InjectedFault`,
                      an ``OSError`` → transient under ``IOPolicy``);
  * ``short_read``  — raise a :class:`iopolicy.ShortReadError`;
  * ``delay``       — sleep ``delay_s`` then succeed (slow disk);
  * ``stall``       — sleep ``delay_s`` *then raise* (hung read that the
                      deadline must catch);
  * ``stage_failure`` — raise :class:`iopolicy.StageFailure` for
                      ``stage`` (ring failover trigger).

``prob`` (with the injector's seed) thins a schedule
deterministically — two injectors built with the same schedule and seed
fire on exactly the same calls.

:class:`FaultyStore` wraps a ``ParamStore`` and routes its reads
(``layer()`` and ``layer_bytes()``, the mapping the port's
``LayerPrefetcher`` copies from) through ``check("layer_read", key=i)``;
``BlockOffloader`` and ``PageFileStore`` take the injector directly and
check ``kv_d2h``/``kv_h2d``/``kv_d2disk``/``kv_disk2h`` around their
transfers.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple, Type

from .iopolicy import ShortReadError, StageFailure
from .telemetry import clock, resolve_tracer

OP_KINDS = ("layer_read", "kv_h2d", "kv_d2h", "kv_d2disk", "kv_disk2h")
MODES = ("error", "short_read", "delay", "stall", "stage_failure")


class InjectedFault(OSError):
    """The default injected error: an ``OSError`` subclass so ``IOPolicy``
    classifies it transient (retryable), like a real flaky-disk EIO."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    Matches calls to ``check(op, key)`` where ``op == self.op`` and
    (``self.key is None`` or ``key == self.key``). Among matching calls,
    skips the first ``after``, then fires on up to ``times`` calls
    (``times=-1``: every one — a permanent fault). ``prob < 1`` thins
    the firing set with the injector's seeded RNG.
    """

    op: str                                   # one of OP_KINDS
    mode: str = "error"                       # one of MODES
    key: Optional[Any] = None                 # e.g. layer index; None = any
    after: int = 0                            # matching calls to skip first
    times: int = 1                            # firings budget; -1 = forever
    delay_s: float = 0.05                     # delay/stall duration
    stage: int = 0                            # stage_failure target
    prob: float = 1.0                         # seeded thinning
    message: str = ""
    error_type: Type[BaseException] = InjectedFault

    def __post_init__(self):
        if self.op not in OP_KINDS:
            raise ValueError(f"unknown fault op {self.op!r} "
                             f"(expected one of {OP_KINDS})")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r} "
                             f"(expected one of {MODES})")


@dataclasses.dataclass(frozen=True)
class FiredFault:
    """Record of one firing, for assertions and reports."""

    op: str
    key: Any
    mode: str
    call_index: int          # per-(spec) matching-call counter at firing
    t: float                 # shared telemetry-clock timestamp


class FaultInjector:
    """Thread-safe deterministic injector over a list of FaultSpecs.

    ``check(op, key)`` is called by instrumented I/O paths; it consults
    every spec (so overlapping schedules compose) and fires the first
    one whose window and seeded coin match. ``fired`` records firings on
    the shared telemetry clock; an attached ``tracer`` additionally gets a
    live instant event per firing.
    """

    def __init__(self, schedule: Sequence[FaultSpec], *, seed: int = 0,
                 tracer=None):
        self.schedule = list(schedule)
        self.seed = seed
        self.tracer = resolve_tracer(tracer)
        self.fired: List[FiredFault] = []
        self._lock = threading.Lock()
        self._seen: List[int] = [0] * len(self.schedule)   # matching calls
        self._shot: List[int] = [0] * len(self.schedule)   # firings
        self._rngs = [random.Random((seed << 8) ^ idx)
                      for idx in range(len(self.schedule))]

    # -- bookkeeping ------------------------------------------------------ #

    def counts(self) -> List[Tuple[int, int]]:
        """(matching_calls, firings) per spec — test observability."""
        with self._lock:
            return list(zip(self._seen, self._shot))

    def exhausted(self) -> bool:
        """True when every finite spec has used its firing budget."""
        with self._lock:
            return all(s.times >= 0 and shot >= s.times
                       for s, shot in zip(self.schedule, self._shot))

    # -- the chokepoint --------------------------------------------------- #

    def check(self, op: str, key: Any = None) -> None:
        """Maybe inject a fault for this call; no-op when nothing fires."""
        to_fire: Optional[Tuple[FaultSpec, int]] = None
        with self._lock:
            for idx, spec in enumerate(self.schedule):
                if spec.op != op:
                    continue
                if spec.key is not None and key != spec.key:
                    continue
                seen = self._seen[idx]
                self._seen[idx] = seen + 1
                if seen < spec.after:
                    continue
                if spec.times >= 0 and self._shot[idx] >= spec.times:
                    continue
                if spec.prob < 1.0 and \
                        self._rngs[idx].random() >= spec.prob:
                    continue
                if to_fire is None:      # first matching spec wins
                    self._shot[idx] += 1
                    self.fired.append(FiredFault(
                        op=op, key=key, mode=spec.mode, call_index=seen,
                        t=clock()))
                    to_fire = (spec, seen)
        if to_fire is None:
            return
        spec, seen = to_fire
        self.tracer.instant(f"fault:{spec.mode}:{op}", cat="fault",
                            track="faults", key=key, call_index=seen)
        self._raise(spec, op, key, seen)

    def _raise(self, spec: FaultSpec, op: str, key: Any, seen: int) -> None:
        msg = spec.message or (
            f"injected {spec.mode} fault on {op}"
            f"{f'[{key}]' if key is not None else ''} (call {seen})")
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return
        if spec.mode == "stall":
            time.sleep(spec.delay_s)
            raise spec.error_type(msg)
        if spec.mode == "short_read":
            raise ShortReadError(
                msg, layer=key if isinstance(key, int) else -1,
                path=f"<injected:{op}>", expected=1, got=0)
        if spec.mode == "stage_failure":
            raise StageFailure(f"{msg}: stage {spec.stage} unreachable",
                               stage=spec.stage)
        raise spec.error_type(msg)       # mode == "error"


class FaultyStore:
    """``ParamStore`` proxy that routes layer reads through a FaultInjector.

    Wrap the store *before* handing it to a prefetcher or a streamed
    source: ``store = FaultyStore(ParamStore(d), injector)``. The read
    chokepoints are instrumented: ``layer(i)`` and ``layer_bytes(i)`` (the
    flat mapping the port's ``LayerPrefetcher`` stages from) each check
    ``layer_read`` with key ``i``. ``willneed`` (the madvise hint) stays
    clean, and everything else (``leaves``, ``head``, ``release``,
    ``reopen``, attributes like ``n_layers``) delegates.
    """

    def __init__(self, store, injector: FaultInjector):
        self._store = store
        self.injector = injector

    def layer(self, i: int):
        self.injector.check("layer_read", key=i)
        return self._store.layer(i)

    def layer_bytes(self, i: int):
        self.injector.check("layer_read", key=i)
        return self._store.layer_bytes(i)

    def willneed(self, i: int) -> None:
        # prefetch hints share the disk path but are advisory; only
        # hard faults on the actual read matter, so hints stay clean.
        self._store.willneed(i)

    def reopen(self, i: int) -> None:
        reopen = getattr(self._store, "reopen", None)
        if reopen is not None:
            reopen(i)

    def __getattr__(self, name):
        return getattr(self._store, name)

    def __enter__(self) -> "FaultyStore":
        return self

    def __exit__(self, *exc) -> None:
        self._store.close()
