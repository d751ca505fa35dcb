"""Runtime telemetry of the port: one clock, the span tracer, per-token
stall attribution and Chrome-trace export (``repro.runtime.telemetry``,
which imports no JAX, copied).

  * **one clock** -- :func:`clock` (``time.perf_counter``). The engine
    stamps request timings with it, the I/O policy its deadlines, the
    prefetcher its layer reads, so every record merges into one timeline.
  * **a tracer** -- :class:`Tracer`: a thread-safe *bounded ring buffer*
    of typed events (:class:`SpanEvent` / :class:`CounterEvent` /
    :class:`InstantEvent`). A disabled tracer (:data:`NULL_TRACER`, the
    default everywhere) returns at one attribute check per call site;
    an enabled one may keep a deterministic 1-in-N sample. The buffer
    never grows past ``capacity``; ``evicted`` counts what wrapped away.
  * **per-token stall attribution** -- :meth:`Tracer.token_step` opens a
    step scope on the calling thread; :meth:`Tracer.phase` calls inside
    it (the prefetcher's blocked ``get()``, the engine's decode call and
    its host sync) accumulate **exclusive** time per component
    (``disk_wait``, ``staging_copy``, ``h2d``, ``compute``, ``comms``),
    the remainder booked to ``sched_idle``, so the components sum to the
    step's measured wall time by construction (:class:`StallRecord`).
    Host clocks only: a phase around device work measures it only where
    the phase ends in a host sync (the engine's ``compute`` does).
  * **Chrome trace export** -- :meth:`Tracer.chrome_trace` /
    :meth:`Tracer.export_chrome_trace` write Chrome Trace Event Format
    JSON (one track per worker thread or named track) that loads in
    Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``;
    :func:`validate_chrome_trace` checks one.

Legacy record types (``PrefetchEvent`` timelines of the prefetcher and
the KV offloader, ``FiredFault`` audit trails, ``WorkerHealth``) merge
onto the shared timeline through the ``ingest_*`` adapters, while the hot
paths also emit live when a tracer is attached; the ring's failover
(``runtime.failover``) lands through ``ingest_failover_event``.

Validator CLI::

    python -m repro_torch.runtime.telemetry --validate trace.json \\
        --require prefetcher decode
"""
from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

#: the one runtime clock: monotonic, high resolution, the same base every
#: subsystem stamps against
clock = time.perf_counter

#: canonical stall-attribution components. ``phase()`` names outside
#: this set accumulate into ``other``; the un-phased remainder of a step
#: is ``sched_idle``. Together they partition the step wall time.
COMPONENTS = ("disk_wait", "staging_copy", "h2d", "compute", "comms",
              "sched_idle", "other")


# --------------------------------------------------------------------------- #
#  typed event schema
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """A named interval on one track (Chrome ``ph="X"``)."""

    name: str
    cat: str
    track: str
    t_start: float
    t_end: float
    args: Tuple[Tuple[str, Any], ...] = ()

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass(frozen=True)
class CounterEvent:
    """A sampled scalar (Chrome ``ph="C"`` — a value-over-time graph)."""

    name: str
    track: str
    t: float
    value: float


@dataclasses.dataclass(frozen=True)
class InstantEvent:
    """A point event (Chrome ``ph="i"`` — e.g. a fired fault)."""

    name: str
    cat: str
    track: str
    t: float
    args: Tuple[Tuple[str, Any], ...] = ()


TraceEvent = Union[SpanEvent, CounterEvent, InstantEvent]


@dataclasses.dataclass(frozen=True)
class StallRecord:
    """Per-token (per-step) stall attribution.

    Exclusive seconds per component; ``sched_idle_s`` is the measured
    wall time not inside any phase, so the components always sum to
    ``wall_s`` up to float rounding.
    """

    index: int                    # token/step index
    t_start: float
    t_end: float
    disk_wait_s: float = 0.0      # front blocked waiting on a layer/bank
    staging_copy_s: float = 0.0   # synchronous host staging copies
    h2d_s: float = 0.0            # synchronous host->device transfers
    compute_s: float = 0.0        # step calls and their host sync
    comms_s: float = 0.0          # collectives measured outside compute
    sched_idle_s: float = 0.0     # engine bookkeeping / python overhead
    other_s: float = 0.0          # non-canonical phase names

    @property
    def wall_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def accounted_s(self) -> float:
        return (self.disk_wait_s + self.staging_copy_s + self.h2d_s
                + self.compute_s + self.comms_s + self.sched_idle_s
                + self.other_s)

    def component(self, name: str) -> float:
        return getattr(self, f"{name}_s")


def stall_summary(records: Sequence[StallRecord]) -> Dict[str, float]:
    """Mean seconds per component over a record stream, plus ``wall``
    (mean TPOT) and ``n`` — the shape the ``--metrics-interval`` report
    consumes."""
    out = {c: 0.0 for c in COMPONENTS}
    out["wall"] = 0.0
    out["n"] = float(len(records))
    if not records:
        return out
    for r in records:
        for c in COMPONENTS:
            out[c] += r.component(c)
        out["wall"] += r.wall_s
    for k in (*COMPONENTS, "wall"):
        out[k] /= len(records)
    return out


def format_summary(summary: Dict[str, float]) -> str:
    """One operator-facing line: mean TPOT and its split."""
    wall = summary.get("wall", 0.0)
    parts = ", ".join(
        f"{c} {summary.get(c, 0.0) * 1e3:.2f}" for c in COMPONENTS
        if summary.get(c, 0.0) > 0.0)
    return (f"tpot {wall * 1e3:.2f} ms over {int(summary.get('n', 0))} "
            f"steps [{parts} ms]")


# --------------------------------------------------------------------------- #
#  token-step scope (stall attribution)
# --------------------------------------------------------------------------- #

class TokenStep:
    """Open step scope: exclusive-time phase accounting on one thread.

    Entering a nested phase *pauses* the enclosing one (the prefetcher's
    ``disk_wait`` inside the engine's ``compute`` is charged to
    ``disk_wait``, not double-counted), so the recorded components
    partition the phased time exactly.
    """

    __slots__ = ("index", "track", "t_start", "components", "_stack")

    def __init__(self, index: int, track: str, t_start: float):
        self.index = index
        self.track = track
        self.t_start = t_start
        self.components: Dict[str, float] = {}
        self._stack: List[List[Any]] = []     # [name, t_resumed]

    def enter_phase(self, name: str, t: float) -> None:
        if self._stack:
            top = self._stack[-1]
            self.components[top[0]] = self.components.get(top[0], 0.0) \
                + (t - top[1])
        self._stack.append([name, t])

    def exit_phase(self, t: float) -> None:
        name, t0 = self._stack.pop()
        self.components[name] = self.components.get(name, 0.0) + (t - t0)
        if self._stack:
            self._stack[-1][1] = t

    def finish(self, t_end: float) -> StallRecord:
        while self._stack:                    # abandoned phases (errors)
            self.exit_phase(t_end)
        known = {c: 0.0 for c in COMPONENTS}
        for name, secs in self.components.items():
            known[name if name in known else "other"] += secs
        phased = sum(known.values())
        known["sched_idle"] = max((t_end - self.t_start) - phased, 0.0)
        return StallRecord(
            index=self.index, t_start=self.t_start, t_end=t_end,
            **{f"{c}_s": known[c] for c in COMPONENTS})


# --------------------------------------------------------------------------- #
#  the tracer
# --------------------------------------------------------------------------- #

class Tracer:
    """Thread-safe bounded-ring-buffer span/counter tracer.

    ``enabled=False`` (or :data:`NULL_TRACER`) is the production default:
    every emission path checks the flag first and returns without
    allocating or locking, so instrumentation can stay compiled into the
    hot paths permanently. ``sample=1/N`` keeps every N-th event
    (deterministic — no RNG), bounding trace size on long serves while
    stall attribution (which aggregates, not stores-per-event) stays
    exact.
    """

    def __init__(self, *, enabled: bool = True, capacity: int = 65536,
                 sample: float = 1.0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not (0.0 < sample <= 1.0):
            raise ValueError("sample must be in (0, 1]")
        self.enabled = enabled
        self.capacity = capacity
        self._keep_every = max(1, int(round(1.0 / sample)))
        self._buf: deque = deque(maxlen=capacity)
        self._stalls: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seq = 0
        self.evicted = 0              # events that wrapped off the ring
        self.stalls_evicted = 0

    # -- clock ------------------------------------------------------------- #

    @staticmethod
    def now() -> float:
        return clock()

    # -- emission ---------------------------------------------------------- #

    def _append(self, ev: TraceEvent) -> None:
        with self._lock:
            self._seq += 1
            if self._keep_every > 1 and self._seq % self._keep_every:
                return
            if len(self._buf) == self.capacity:
                self.evicted += 1
            self._buf.append(ev)

    def span_event(self, name: str, t_start: float, t_end: float, *,
                   cat: str = "span", track: Optional[str] = None,
                   **args) -> None:
        if not self.enabled:
            return
        self._append(SpanEvent(
            name=name, cat=cat, track=track or _thread_track(),
            t_start=t_start, t_end=t_end,
            args=tuple(sorted(args.items()))))

    def instant(self, name: str, *, cat: str = "instant",
                track: Optional[str] = None, t: Optional[float] = None,
                **args) -> None:
        if not self.enabled:
            return
        self._append(InstantEvent(
            name=name, cat=cat, track=track or _thread_track(),
            t=t if t is not None else clock(),
            args=tuple(sorted(args.items()))))

    def counter(self, name: str, value: float, *,
                track: Optional[str] = None,
                t: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self._append(CounterEvent(
            name=name, track=track or _thread_track(),
            t=t if t is not None else clock(), value=float(value)))

    @contextmanager
    def span(self, name: str, *, cat: str = "span",
             track: Optional[str] = None, **args):
        """Time a block as one span. No-op (no clock reads) when
        disabled."""
        if not self.enabled:
            yield
            return
        t0 = clock()
        try:
            yield
        finally:
            self.span_event(name, t0, clock(), cat=cat, track=track,
                            **args)

    # -- stall attribution ------------------------------------------------- #

    @contextmanager
    def token_step(self, index: int, *, track: str = "decode",
                   name: Optional[str] = None, **args):
        """Open a per-token step scope on this thread. ``phase()`` calls
        underneath (in this thread) attribute into it; on exit a
        :class:`StallRecord` is appended and the step is emitted as a
        span on the ``track`` timeline."""
        if not self.enabled:
            yield None
            return
        prev = getattr(self._local, "step", None)
        step = TokenStep(index, track, clock())
        self._local.step = step
        try:
            yield step
        finally:
            t_end = clock()
            self._local.step = prev
            rec = step.finish(t_end)
            with self._lock:
                if len(self._stalls) == self.capacity:
                    self.stalls_evicted += 1
                self._stalls.append(rec)
            self.span_event(name or f"token[{index}]", step.t_start,
                            t_end, cat="decode", track=track,
                            disk_wait_ms=round(rec.disk_wait_s * 1e3, 3),
                            compute_ms=round(rec.compute_s * 1e3, 3),
                            **args)

    def current_step(self) -> Optional[TokenStep]:
        return getattr(self._local, "step", None)

    @contextmanager
    def phase(self, name: str, *, cat: str = "phase",
              track: Optional[str] = None, min_dur: float = 0.0,
              label: Optional[str] = None, **args):
        """Attribute a block to stall component ``name``.

        Inside an open :meth:`token_step` on this thread the exclusive
        duration lands on that step's record; a span is also emitted
        (named ``label`` if given, suppressed under ``min_dur`` — e.g.
        the prefetcher's usually-instant ``disk_wait`` waits only trace
        when they actually stalled). Disabled tracer: straight
        passthrough.
        """
        if not self.enabled:
            yield
            return
        step = getattr(self._local, "step", None)
        t0 = clock()
        if step is not None:
            step.enter_phase(name, t0)
        try:
            yield
        finally:
            t1 = clock()
            if step is not None:
                step.exit_phase(t1)
            if t1 - t0 >= min_dur:
                self.span_event(label or name, t0, t1, cat=cat,
                                track=track, **args)

    # -- snapshots --------------------------------------------------------- #

    def events(self) -> List[TraceEvent]:
        with self._lock:
            return list(self._buf)

    def stalls(self) -> List[StallRecord]:
        with self._lock:
            return list(self._stalls)

    def summary(self, last_n: Optional[int] = None) -> Dict[str, float]:
        recs = self.stalls()
        if last_n is not None:
            recs = recs[-last_n:]
        return stall_summary(recs)

    def tracks(self) -> List[str]:
        seen: Dict[str, None] = {}
        for ev in self.events():
            seen.setdefault(ev.track)
        return list(seen)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._stalls.clear()
            self._seq = 0
            self.evicted = 0
            self.stalls_evicted = 0

    # -- legacy-record ingestion ------------------------------------------- #

    def ingest_prefetch_events(self, events: Iterable, *,
                               track: str = "prefetcher",
                               cat: str = "prefetch",
                               name: str = "layer_read") -> int:
        """Merge a ``PrefetchEvent`` timeline (layer prefetcher or KV
        offloader — they share the record type and the clock) onto the
        trace as spans. Returns events ingested."""
        n = 0
        for e in events:
            self.span_event(f"{name}[{e.layer}]", e.t_start, e.t_end,
                            cat=cat, track=track, nbytes=e.nbytes)
            n += 1
        return n

    def ingest_fired_faults(self, fired: Iterable, *,
                            track: str = "faults") -> int:
        """``faults.FiredFault`` audit trail -> instant events (same
        clock: the fault injector stamps with ``telemetry.clock``)."""
        n = 0
        for f in fired:
            self.instant(f"fault:{f.mode}:{f.op}", cat="fault",
                         track=track, t=f.t, key=f.key,
                         call_index=f.call_index)
            n += 1
        return n

    def ingest_failover_event(self, ev, *, t_end: Optional[float] = None,
                              track: str = "failover") -> None:
        """``failover.FailoverEvent`` -> its detect/resolve/rebuild/replay
        split as contiguous spans ending at ``t_end`` (default: now)."""
        t1 = t_end if t_end is not None else clock()
        t0 = t1 - ev.recovery_s
        edges = [t0]
        for d in (ev.detect_s, ev.resolve_s, ev.rebuild_s, ev.replay_s):
            edges.append(edges[-1] + d)
        for name, a, b in zip(("detect", "resolve", "rebuild", "replay"),
                              edges[:-1], edges[1:]):
            self.span_event(f"failover/{name}", a, b, cat="failover",
                            track=track, token_index=ev.token_index,
                            failed_stage=ev.failed_stage,
                            stages_after=ev.n_stages_after)

    def ingest_worker_health(self, health, *,
                             track: Optional[str] = None) -> None:
        """``iopolicy.WorkerHealth`` -> an instant + counters on the
        worker's own track."""
        tr = track or health.name or "worker"
        self.instant(f"health:{health.report()}", cat="health", track=tr,
                     t=health.last_progress_t)
        self.counter("retries", health.retries, track=tr)
        self.counter("failures", health.failures, track=tr)

    # -- Chrome trace (Perfetto) export ------------------------------------ #

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome Trace Event Format dict (``traceEvents`` +
        ``displayTimeUnit``) — loads in Perfetto / chrome://tracing.
        One pid, one tid per track, tracks named via metadata events."""
        events = self.events()
        t0 = min((ev.t_start if isinstance(ev, SpanEvent) else ev.t
                  for ev in events), default=0.0)
        tids: Dict[str, int] = {}
        out: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": "repro-runtime"}}]

        def tid(track: str) -> int:
            if track not in tids:
                tids[track] = len(tids) + 1
                out.append({"name": "thread_name", "ph": "M", "pid": 1,
                            "tid": tids[track], "args": {"name": track}})
            return tids[track]

        for ev in events:
            if isinstance(ev, SpanEvent):
                out.append({
                    "name": ev.name, "cat": ev.cat or "span", "ph": "X",
                    "ts": (ev.t_start - t0) * 1e6,
                    "dur": max(ev.duration, 0.0) * 1e6,
                    "pid": 1, "tid": tid(ev.track),
                    "args": dict(ev.args)})
            elif isinstance(ev, CounterEvent):
                out.append({
                    "name": ev.name, "ph": "C",
                    "ts": (ev.t - t0) * 1e6, "pid": 1,
                    "tid": tid(ev.track),
                    "args": {"value": ev.value}})
            else:
                out.append({
                    "name": ev.name, "cat": ev.cat or "instant",
                    "ph": "i", "s": "t", "ts": (ev.t - t0) * 1e6,
                    "pid": 1, "tid": tid(ev.track),
                    "args": dict(ev.args)})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "metadata": {"evicted": self.evicted,
                             "stalls_evicted": self.stalls_evicted,
                             "complete": self.evicted == 0}}

    def export_chrome_trace(self, path: str) -> str:
        doc = self.chrome_trace()
        if self.evicted:
            # a truncated trace must never pass for a complete one
            logging.getLogger(__name__).warning(
                "trace %s is truncated: ring evicted %d events "
                "(%d token-step stall records) — raise Tracer(capacity=)",
                path, self.evicted, self.stalls_evicted)
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return path


def _thread_track() -> str:
    return threading.current_thread().name


#: the shared disabled tracer: instrumented code defaults to it so the
#: hot paths never branch on ``None``.
NULL_TRACER = Tracer(enabled=False, capacity=1)


def resolve_tracer(tracer) -> Tracer:
    """``NULL_TRACER`` for ``None``, the tracer itself for a ``Tracer``;
    anything else raises ``TypeError``."""
    if tracer is None:
        return NULL_TRACER
    if not isinstance(tracer, Tracer):
        raise TypeError(f"tracer must be a telemetry.Tracer or None, got "
                        f"{type(tracer).__name__}")
    return tracer


# --------------------------------------------------------------------------- #
#  trace validation
# --------------------------------------------------------------------------- #

def validate_chrome_trace(path: str,
                          require_tracks: Sequence[str] = ()
                          ) -> Dict[str, Any]:
    """Parse a Chrome-trace JSON and check schema invariants.

    Raises ``ValueError`` on a malformed trace or a missing required
    track (substring match against thread names). Returns a summary
    dict (tracks, event/phase counts) for reporting.
    """
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome trace "
                         "(missing traceEvents)")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError(f"{path}: empty traceEvents")
    tracks: List[str] = []
    phases: Dict[str, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"{path}: event {i} is not an object")
        ph = ev.get("ph")
        if ph not in ("X", "C", "i", "M", "B", "E"):
            raise ValueError(f"{path}: event {i} has unknown ph {ph!r}")
        phases[ph] = phases.get(ph, 0) + 1
        if ph == "M":
            if ev.get("name") == "thread_name":
                tracks.append(str(ev["args"]["name"]))
            continue
        for key in ("name", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"{path}: event {i} missing {key!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"{path}: event {i} bad ts {ev['ts']!r}")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            raise ValueError(f"{path}: event {i} bad dur "
                             f"{ev.get('dur')!r}")
    missing = [want for want in require_tracks
               if not any(want in t for t in tracks)]
    if missing:
        raise ValueError(
            f"{path}: required tracks missing: {missing} "
            f"(present: {tracks})")
    evicted = int(doc.get("metadata", {}).get("evicted", 0))
    return {"tracks": tracks, "n_events": len(events), "phases": phases,
            "evicted": evicted}


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate a Chrome-trace JSON exported by "
                    "repro_torch.runtime.telemetry")
    ap.add_argument("--validate", required=True, metavar="TRACE_JSON")
    ap.add_argument("--require", nargs="*", default=(),
                    help="track-name substrings that must be present")
    args = ap.parse_args(argv)
    info = validate_chrome_trace(args.validate, args.require)
    print(f"{args.validate}: valid Chrome trace — "
          f"{info['n_events']} events, tracks {info['tracks']}, "
          f"phases {info['phases']}")
    if info["evicted"]:
        print(f"WARNING: trace is truncated — ring evicted "
              f"{info['evicted']} events")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
