"""Shared I/O retry/backoff policy and error taxonomy for the runtime.

A copy of ``repro.runtime.iopolicy`` (standard library only), so the
port's store and prefetcher classify failures as the JAX package's do.

The paper's operating point — weights streamed from consumer SSDs, KV
pages bounced over host links, stages living on flaky home machines —
makes I/O failure the common case, not the exception. Every worker
thread in ``runtime.streaming`` and ``runtime.kvcache`` funnels its disk
reads and host<->device transfers through one :class:`IOPolicy`, so the
whole runtime shares a single answer to the three questions that matter:

  * **is this error transient or fatal?** (``classify``): ``OSError``
    (flaky disk, short read, injected I/O fault) is transient and worth
    retrying with the mmap re-opened; shape/type/corruption errors are
    fatal — retrying a truncated manifest only burns the deadline.
  * **how long do we keep trying?** bounded retries under exponential
    backoff with deterministic jitter, all inside a per-op deadline so a
    silently hung ``read()`` becomes a detectable :class:`StallTimeout`
    instead of a forever-blocked ``get()``.
  * **what does the caller see?** one classified exception type per
    outcome — :class:`FatalIOError` (gave up), :class:`StallTimeout`
    (deadline), :class:`StageFailure` (a ring stage died; the failover
    driver keys on this) — each carrying enough context (op name,
    attempts, cause chain) to log or act on.

:class:`WorkerHealth` is the watchdog half: a tiny mutable record of
consecutive failures, retry totals, and a last-progress timestamp that
``PrefetchStats`` and stall reports surface, so degradation is visible
before it becomes an outage.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Type, TypeVar

from .telemetry import clock

T = TypeVar("T")


# --------------------------------------------------------------------------- #
#  error taxonomy
# --------------------------------------------------------------------------- #

class ShortReadError(OSError):
    """A layer file is smaller than the manifest says it should be.

    Raised by ``ParamStore.layer()`` when the mapping cannot cover
    ``layer_nbytes`` — the classified form of "the file was truncated
    after the manifest loaded". Transient by classification (a writer
    may still be flushing; a retry re-opens the mapping), but it names
    the layer and file so the fatal wrap-up after retries exhaust is
    actionable instead of a shape crash deep in jax.
    """

    def __init__(self, msg: str, *, layer: int = -1, path: str = "",
                 expected: int = 0, got: int = 0):
        super().__init__(msg)
        self.layer = layer
        self.path = path
        self.expected = expected
        self.got = got


class BudgetExceeded(OSError):
    """A tier of the shared memory budget refused an allocation.

    An ``OSError`` subclass so :class:`IOPolicy` classifies it
    *transient*: a refusal is usually a full tier whose bytes another
    slot is about to release (a finishing sequence, a layer falling
    behind the compute front), so a bounded retry under backoff is the
    right response — unbounded growth past the budget never is. Carries
    the tier and the byte arithmetic so the fatal wrap-up after retries
    exhaust names the actual pressure instead of a bare refusal.
    """

    def __init__(self, msg: str, *, tier: str = "", requested: int = 0,
                 used: int = 0, capacity: int = 0):
        super().__init__(msg)
        self.tier = tier
        self.requested = requested
        self.used = used
        self.capacity = capacity


class FatalIOError(RuntimeError):
    """An I/O op failed permanently: retries exhausted or the error was
    classified fatal. ``__cause__`` holds the last underlying error."""

    def __init__(self, msg: str, *, op: str = "", attempts: int = 0):
        super().__init__(msg)
        self.op = op
        self.attempts = attempts


class StallTimeout(FatalIOError):
    """An op (or a ``get()`` waiting on a worker) exceeded its deadline —
    the detectable form of a silent stall."""


class StageFailure(RuntimeError):
    """A pipeline stage died (injected or detected). Carries the mesh
    stage index under the *current* plan; the elastic failover driver
    walks exception cause chains looking for this type."""

    def __init__(self, msg: str, *, stage: int = -1):
        super().__init__(msg)
        self.stage = stage


def find_cause(exc: BaseException,
               cls: Type[BaseException]) -> Optional[BaseException]:
    """Walk ``__cause__``/``__context__`` looking for an instance of
    ``cls`` (e.g. dig a ``StageFailure`` out of the RuntimeError a
    prefetcher ``get()`` raised)."""
    seen = set()
    cur: Optional[BaseException] = exc
    while cur is not None and id(cur) not in seen:
        if isinstance(cur, cls):
            return cur
        seen.add(id(cur))
        cur = cur.__cause__ if cur.__cause__ is not None else cur.__context__
    return None


# --------------------------------------------------------------------------- #
#  watchdog / health
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class WorkerHealth:
    """Mutable health record for one worker thread.

    Written by the worker (under its condition lock or from the single
    worker thread), read by ``get()`` timeouts, ``stats()``, and stall
    reports. Plain attributes — torn reads of a float timestamp are
    harmless for a health display. ``last_progress_t`` is stamped on the
    shared :func:`runtime.telemetry.clock`, so health records merge onto
    the same timeline as prefetch events and fault audit trails.
    """

    name: str = ""
    consecutive_failures: int = 0
    failures: int = 0                 # every failed attempt
    retries: int = 0                  # failed attempts that were retried
    last_error: Optional[str] = None
    last_progress_t: float = dataclasses.field(default_factory=clock)
    stalled: bool = False
    closed: bool = False

    def progress(self) -> None:
        self.consecutive_failures = 0
        self.last_progress_t = clock()

    def failure(self, exc: BaseException) -> None:
        self.failures += 1
        self.consecutive_failures += 1
        self.last_error = f"{type(exc).__name__}: {exc}"

    def seconds_since_progress(self) -> float:
        return clock() - self.last_progress_t

    def report(self) -> str:
        state = "stalled" if self.stalled else (
            "closed" if self.closed else "live")
        msg = (f"{self.name or 'worker'}: {state}, "
               f"{self.consecutive_failures} consecutive failures "
               f"({self.failures} total, {self.retries} retried), "
               f"last progress {self.seconds_since_progress():.1f}s ago")
        if self.last_error:
            msg += f", last error: {self.last_error}"
        return msg


# --------------------------------------------------------------------------- #
#  the policy
# --------------------------------------------------------------------------- #

#: exception types retrying cannot fix — give up immediately.
_FATAL_TYPES = (FatalIOError, StageFailure, ValueError, TypeError,
                IndexError, KeyError, AssertionError, NotImplementedError,
                MemoryError, ArithmeticError)

#: exception types worth retrying (flaky disk / transport).
_TRANSIENT_TYPES = (OSError, TimeoutError, BufferError, ConnectionError)


@dataclasses.dataclass(frozen=True)
class IOPolicy:
    """Retry/backoff/deadline policy shared by all runtime I/O paths.

    ``run(op, fn)`` executes ``fn`` with up to ``max_retries`` retries of
    transient errors, exponential backoff with deterministic jitter, and
    a per-op wall-clock deadline. Control-flow exceptions
    (``KeyboardInterrupt``/``SystemExit``) always propagate untouched —
    they are never latched, retried, or wrapped.
    """

    max_retries: int = 3
    backoff_base_s: float = 0.01
    backoff_max_s: float = 1.0
    jitter: float = 0.5               # +- fraction of the backoff step
    op_deadline_s: float = 30.0       # wall-clock budget per op incl. retries
    get_timeout_s: float = 60.0       # consumer-side get() default timeout
    seed: int = 0

    def classify(self, exc: BaseException) -> str:
        """"transient" (retry) or "fatal" (give up). Unknown types are
        fatal — retrying an error we cannot name hides bugs."""
        if isinstance(exc, _FATAL_TYPES):
            return "fatal"
        if isinstance(exc, _TRANSIENT_TYPES):
            return "transient"
        return "fatal"

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry ``attempt`` (1-based), jittered."""
        base = min(self.backoff_base_s * (2.0 ** (attempt - 1)),
                   self.backoff_max_s)
        if self.jitter <= 0:
            return base
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))

    def run(self, op: str, fn: Callable[[], T], *,
            reopen: Optional[Callable[[], None]] = None,
            health: Optional[WorkerHealth] = None) -> T:
        """Run ``fn`` under this policy; returns its value.

        ``reopen`` (e.g. re-mmap a layer file) runs best-effort before
        each retry. ``health`` accumulates failure/retry counts.
        Raises :class:`FatalIOError` (fatal error or retries exhausted)
        or :class:`StallTimeout` (deadline exceeded); the underlying
        error is chained as ``__cause__``.
        """
        rng = random.Random((self.seed << 20) ^ (hash(op) & 0xFFFFF))
        deadline = clock() + self.op_deadline_s
        attempt = 0
        while True:
            try:
                out = fn()
            except (KeyboardInterrupt, SystemExit):
                raise                   # control flow, never I/O policy's
            except BaseException as e:
                attempt += 1
                if health is not None:
                    health.failure(e)
                if self.classify(e) != "transient":
                    raise FatalIOError(
                        f"{op}: fatal error after {attempt} attempt(s): "
                        f"{type(e).__name__}: {e}",
                        op=op, attempts=attempt) from e
                if attempt > self.max_retries:
                    raise FatalIOError(
                        f"{op}: retries exhausted "
                        f"({self.max_retries} retries): "
                        f"{type(e).__name__}: {e}",
                        op=op, attempts=attempt) from e
                now = clock()
                if now >= deadline:
                    raise StallTimeout(
                        f"{op}: deadline {self.op_deadline_s:.1f}s exceeded "
                        f"after {attempt} attempt(s): "
                        f"{type(e).__name__}: {e}",
                        op=op, attempts=attempt) from e
                if health is not None:
                    health.retries += 1
                delay = min(self.backoff_s(attempt, rng),
                            max(deadline - now, 0.0))
                if delay > 0:
                    time.sleep(delay)
                if reopen is not None:
                    try:
                        reopen()
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except BaseException:
                        pass            # next attempt surfaces the error
                continue
            if health is not None:
                health.progress()
            return out


#: a policy tuned for tests/benchmarks: fast backoff, short deadlines.
FAST_TEST_POLICY = IOPolicy(max_retries=3, backoff_base_s=0.002,
                            backoff_max_s=0.02, op_deadline_s=5.0,
                            get_timeout_s=10.0)
