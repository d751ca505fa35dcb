"""Serving metrics of the port: counters, gauges, streaming histograms
(``repro.runtime.metrics``, which imports no JAX, copied).

``runtime/telemetry.py`` sees individual token steps and worker spans;
this layer sees *requests*: p50/p99 TTFT and TPOT, queue wait and shed
classification, without retaining per-sample data.

  * :class:`Counter` — monotonic, labeled (``requests/rejected{reason=…}``).
  * :class:`Gauge` — last-value, fed by registered sample sources
    (the batcher's slots, the block pool's pages, …).
  * :class:`LogHistogram` — streaming log-bucketed histogram: geometric
    buckets (growth ``1.1`` ≈ 4.8% worst-case quantile error), a sparse
    ``bucket→count`` dict, exact ``count/sum/min/max``, mergeable across
    registries, p50/p90/p99 in O(buckets) — no samples retained.
  * :class:`MetricsRegistry` — thread-safe home for all of the above,
    with three exposure paths: :meth:`MetricsRegistry.prometheus_text`,
    a JSON :meth:`MetricsRegistry.snapshot` checked by
    :func:`validate_metrics_snapshot`, and the rolling
    ``serve --metrics-interval`` line.
  * :class:`RequestTrace` / :class:`RequestTracker` — per-request
    lifecycle (submit → queue_wait → admit → prefill → per-token decode
    → finish/reject) recorded by ``ContinuousBatcher``; finished traces
    land in a bounded log, the exact samples the histograms summarize.

Recording is a dict increment under a lock, and an engine built with
``metrics=None`` pays nothing (every call site is guarded). The snapshot
schema is the JAX package's, so either package's validator reads either
package's snapshot::

    python -m repro_torch.runtime.metrics --validate OUT.json
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .telemetry import clock

SCHEMA = "repro-metrics-v1"
DEFAULT_GROWTH = 1.1


def _label_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. ``inc`` with a negative amount raises."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self.value += n


class Gauge:
    """Last-value gauge (free to move both ways)."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class LogHistogram:
    """Streaming log-bucketed histogram.

    Positive observations land in geometric buckets
    ``[growth**i, growth**(i+1))``; zero/negative observations share a
    dedicated zero bucket (durations can legitimately round to 0).
    Quantiles walk the cumulative counts and return the geometric bucket
    midpoint clamped to the exact ``[min, max]`` — so any quantile is
    within one bucket of relative error (a factor of ``growth``) of the
    same-rank exact sample, and p0/p100 are exact. Merging sums sparse
    bucket dicts, which is associative and lossless (registries shard
    across workers and merge at export).
    """

    __slots__ = ("growth", "_lg", "count", "total", "min", "max",
                 "zero_count", "buckets", "_lock")

    def __init__(self, growth: float = DEFAULT_GROWTH):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = float(growth)
        self._lg = math.log(self.growth)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.zero_count = 0
        self.buckets: Dict[int, int] = {}
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if v <= 0.0:
                self.zero_count += 1
            else:
                idx = math.floor(math.log(v) / self._lg)
                self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def merge(self, other: "LogHistogram") -> None:
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError("cannot merge histograms with different growth")
        with self._lock, other._lock:
            self.count += other.count
            self.total += other.total
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
            self.zero_count += other.zero_count
            for idx, c in other.buckets.items():
                self.buckets[idx] = self.buckets.get(idx, 0) + c

    def quantile(self, q: float) -> float:
        """Inverted-CDF quantile: the bucket of the smallest sample whose
        cumulative count reaches ``ceil(q * count)`` (matches
        ``numpy.quantile(..., method="inverted_cdf")`` up to bucket
        rounding)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if self.count == 0:
                return math.nan
            if q == 0.0:
                return self.min            # extremes are tracked exactly
            if q == 1.0:
                return self.max
            target = max(1, math.ceil(q * self.count))
            cum = self.zero_count
            if cum >= target:
                # zero-bucket sample: its exact value is <= 0, clamp into
                # the observed range
                return min(max(0.0, self.min), self.max)
            for idx in sorted(self.buckets):
                cum += self.buckets[idx]
                if cum >= target:
                    mid = self.growth ** (idx + 0.5)
                    return min(max(mid, self.min), self.max)
            return self.max          # unreachable unless counts drifted

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        return [self.quantile(q) for q in qs]

    def state(self) -> dict:
        with self._lock:
            return {
                "growth": self.growth,
                "count": self.count,
                "sum": self.total,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "zero_count": self.zero_count,
                "buckets": {str(i): c for i, c in sorted(self.buckets.items())},
            }


@dataclasses.dataclass
class RequestTrace:
    """One request's lifecycle timestamps (shared ``telemetry.clock``)."""

    uid: int
    submit_t: float
    prompt_len: int = 0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    n_tokens: int = 0
    max_gap_s: float = 0.0            # worst inter-token gap (stall peak)
    restored: bool = False            # parked-session restore admit
    outcome: str = "pending"          # pending | finished | shed | rejected
    reason: str = ""                  # reject/shed classification code

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_t is None:
            return None
        return max(self.admit_t - self.submit_t, 0.0)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return max(self.first_token_t - self.submit_t, 0.0)

    @property
    def tpot_s(self) -> Optional[float]:
        if (self.first_token_t is None or self.finish_t is None
                or self.n_tokens < 2):
            return None
        return max(self.finish_t - self.first_token_t, 0.0) \
            / (self.n_tokens - 1)

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return max(self.finish_t - self.submit_t, 0.0)


class MetricsRegistry:
    """Thread-safe registry of counters, gauges and histograms, plus a
    bounded log of completed :class:`RequestTrace` records (the
    exact-sample reference for histogram-agreement gates; evictions are
    counted, never silent)."""

    def __init__(self, *, growth: float = DEFAULT_GROWTH,
                 request_log_size: int = 4096):
        self.growth = growth
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, LogHistogram] = {}
        self._sources: Dict[str, Callable[[], Dict[str, float]]] = {}
        self.request_log: deque = deque(maxlen=request_log_size)
        self.request_log_evicted = 0

    # -- get-or-create accessors --------------------------------------- #

    def counter(self, name: str, **labels) -> Counter:
        key = _label_key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter(name, labels)
            return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = _label_key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge(name, labels)
            return g

    def histogram(self, name: str, **labels) -> LogHistogram:
        key = _label_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = LogHistogram(self.growth)
            return h

    # -- recording shorthands ------------------------------------------ #

    def inc(self, name: str, n: int = 1, **labels) -> None:
        self.counter(name, **labels).inc(n)

    def set_gauge(self, name: str, v: float, **labels) -> None:
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, v: float, **labels) -> None:
        self.histogram(name, **labels).observe(v)

    def record_request(self, trace: RequestTrace) -> None:
        with self._lock:
            if len(self.request_log) == self.request_log.maxlen:
                self.request_log_evicted += 1
            self.request_log.append(trace)

    # -- gauge sampling ------------------------------------------------- #

    def add_source(self, name: str,
                   fn: Callable[[], Dict[str, float]]) -> None:
        """Register a callable returning ``{gauge_name: value}``; polled
        by :meth:`sample` (subsystems expose state without the registry
        reaching into them)."""
        with self._lock:
            self._sources[name] = fn

    def sample(self) -> None:
        with self._lock:
            sources = list(self._sources.values())
        for fn in sources:
            for name, v in fn().items():
                self.set_gauge(name, v)

    # -- exposure ------------------------------------------------------- #

    def snapshot(self) -> dict:
        """JSON-serializable snapshot (validated by
        :func:`validate_metrics_snapshot`)."""
        self.sample()
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()}
            hists = dict(self._hists)
            log_n = len(self.request_log)
            evicted = self.request_log_evicted
        return {
            "schema": SCHEMA,
            "t": clock(),
            "counters": counters,
            "gauges": gauges,
            "histograms": {k: h.state() for k, h in hists.items()},
            "request_log": {"logged": log_n, "evicted": evicted},
        }

    def percentile_summary(self) -> Dict[str, float]:
        """Flat ``{hist/pXX: value}`` dict for rolling console output."""
        out: Dict[str, float] = {}
        with self._lock:
            hists = dict(self._hists)
        for key, h in hists.items():
            if h.count == 0:
                continue
            p50, p90, p99 = h.quantiles((0.5, 0.9, 0.99))
            out[f"{key}/p50"] = p50
            out[f"{key}/p90"] = p90
            out[f"{key}/p99"] = p99
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition: counters as ``_total``, histograms
        as summaries (quantile labels + ``_sum``/``_count``)."""
        lines: List[str] = []
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = [(k, h) for k, h in self._hists.items()]
        typed = set()

        def emit_type(name: str, kind: str):
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for c in counters:
            name = _prom_name(c.name) + "_total"
            emit_type(name, "counter")
            lines.append(f"{name}{_prom_labels(c.labels)} {c.value}")
        for g in gauges:
            name = _prom_name(g.name)
            emit_type(name, "gauge")
            lines.append(f"{name}{_prom_labels(g.labels)} {_fmt(g.value)}")
        for key, h in hists:
            labels = _parse_key_labels(key)
            name = _prom_name(_parse_key_name(key))
            emit_type(name, "summary")
            st = h.state()
            for q in (0.5, 0.9, 0.99):
                lab = dict(labels)
                lab["quantile"] = f"{q}"
                v = h.quantile(q)
                lines.append(f"{name}{_prom_labels(lab)} {_fmt(v)}")
            lines.append(f"{name}_sum{_prom_labels(labels)} "
                         f"{_fmt(st['sum'])}")
            lines.append(f"{name}_count{_prom_labels(labels)} "
                         f"{st['count']}")
            if st["count"]:
                lines.append(f"{name}_min{_prom_labels(labels)} "
                             f"{_fmt(st['min'])}")
                lines.append(f"{name}_max{_prom_labels(labels)} "
                             f"{_fmt(st['max'])}")
        return "\n".join(lines) + "\n"

    def export_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path


def _prom_name(name: str) -> str:
    safe = "".join(ch if (ch.isalnum() or ch == "_") else "_"
                   for ch in name)
    if not safe or not (safe[0].isalpha() or safe[0] == "_"):
        safe = "_" + safe
    return "repro_" + safe


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    def esc(v):  # noqa: E306 — tiny local helper
        return str(v).replace("\\", "\\\\").replace('"', '\\"')
    inner = ",".join(f'{k}="{esc(labels[k])}"' for k in sorted(labels))
    return "{" + inner + "}"


def _parse_key_name(key: str) -> str:
    return key.split("{", 1)[0]


def _parse_key_labels(key: str) -> Dict[str, str]:
    if "{" not in key:
        return {}
    inner = key.split("{", 1)[1].rstrip("}")
    out = {}
    for part in inner.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


def _fmt(v: float) -> str:
    if v != v:                       # NaN
        return "NaN"
    return repr(float(v))


# ---------------------------------------------------------------------- #
# Request lifecycle recorder (ContinuousBatcher-facing)
# ---------------------------------------------------------------------- #

SHED_CODES = ("shed_capacity", "deferred_ttl_expired")


class RequestTracker:
    """Per-request lifecycle recorder bound to a registry.

    The engine calls ``submit`` when a request becomes visible (its
    arrival time passes, or it enters the admit loop), ``admitted`` when
    a slot is claimed (queue wait observed; ``restored=True`` marks a
    parked-session restore), ``token`` per emitted token (the first one
    stamps TTFT), ``finished``/``rejected`` to close the trace. All
    methods are idempotent-friendly and no-ops for unknown uids, so the
    engine never has to special-case restore/defer orderings.
    """

    def __init__(self, registry: MetricsRegistry):
        self.reg = registry
        self._live: Dict[int, RequestTrace] = {}

    def submit(self, uid: int, *, t: Optional[float] = None,
               prompt_len: int = 0) -> None:
        if uid in self._live:
            return
        self._live[uid] = RequestTrace(
            uid=uid, submit_t=clock() if t is None else t,
            prompt_len=prompt_len)
        self.reg.inc("requests/submitted")

    def admitted(self, uid: int, *, restored: bool = False) -> None:
        tr = self._live.get(uid)
        if tr is None:
            return
        tr.admit_t = clock()
        tr.restored = restored
        self.reg.inc("requests/admitted")
        if restored:
            self.reg.inc("requests/restored")
        self.reg.observe("request/queue_wait_s", tr.queue_wait_s)

    def prefill_done(self, uid: int, seconds: float) -> None:
        self.reg.observe("request/prefill_s", seconds)

    def prefill_chunks(self, uid: int, n: int) -> None:
        """Chunked admission: how many paged-prefill chunks this request
        took (1 for an unchunked or fully prefix-shared admit)."""
        self.reg.observe("request/prefill_chunks", float(n))

    def interleave_stall(self, seconds: float) -> None:
        """Time active decode slots spent waiting on one prefill chunk
        before their interleaved step ran — the per-chunk TPOT tax of
        chunked admission (the whole-prefill stall it replaces books
        nothing here; compare ``decode/step_s`` spikes instead)."""
        self.reg.counter("decode/interleave_stall_s").inc(seconds)

    def token(self, uid: int, n: int = 1) -> None:
        tr = self._live.get(uid)
        if tr is None:
            return
        now = clock()
        if tr.first_token_t is None:
            tr.first_token_t = now
            self.reg.observe("request/ttft_s", tr.ttft_s)
        else:
            # worst single stall between emissions — the TPOT *spike* an
            # unchunked long admit causes (averages hide it)
            tr.max_gap_s = max(tr.max_gap_s, now - tr.last_token_t)
        tr.last_token_t = now
        tr.n_tokens += n
        self.reg.inc("tokens/generated", n)

    def finished(self, uid: int) -> None:
        tr = self._live.pop(uid, None)
        if tr is None:
            return
        tr.finish_t = clock()
        tr.outcome = "finished"
        self.reg.inc("requests/finished")
        self.reg.observe("request/e2e_s", tr.e2e_s)
        self.reg.observe("request/tokens", tr.n_tokens)
        if tr.tpot_s is not None:
            self.reg.observe("request/tpot_s", tr.tpot_s)
        if tr.n_tokens >= 2:
            self.reg.observe("request/max_gap_s", tr.max_gap_s)
        self.reg.record_request(tr)

    def rejected(self, uid: int, code: str, reason: str = "") -> None:
        tr = self._live.pop(uid, None)
        if tr is None:
            tr = RequestTrace(uid=uid, submit_t=clock())
        tr.finish_t = clock()
        tr.outcome = "shed" if code in SHED_CODES else "rejected"
        tr.reason = code
        self.reg.inc("requests/rejected", reason=code)
        self.reg.record_request(tr)

    def step_done(self, seconds: float) -> None:
        self.reg.observe("decode/step_s", seconds)


# ---------------------------------------------------------------------- #
# Snapshot validation (mirrors telemetry.validate_chrome_trace)
# ---------------------------------------------------------------------- #

def validate_metrics_snapshot(doc, require: Sequence[str] = ()) -> dict:
    """Validate a metrics snapshot (dict or JSON path): schema marker,
    counter monotonicity (>= 0), histogram internal consistency
    (``count == zero_count + Σ buckets``, ordered quantiles inside
    ``[min, max]``), and that every name in ``require`` matches at least
    one metric key (substring). Raises ``ValueError`` on any violation;
    returns a summary dict."""
    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        raise ValueError(f"not a metrics snapshot (schema != {SCHEMA!r})")
    counters = doc.get("counters", {})
    gauges = doc.get("gauges", {})
    hists = doc.get("histograms", {})
    for key, v in counters.items():
        # seconds-valued counters (e.g. decode/interleave_stall_s) are
        # floats; monotonicity means non-negative and finite either way
        if (not isinstance(v, (int, float)) or isinstance(v, bool)
                or v != v or v < 0):
            raise ValueError(f"counter {key}: non-monotonic value {v!r}")
    for key, v in gauges.items():
        if not isinstance(v, (int, float)) or v != v:
            raise ValueError(f"gauge {key}: non-numeric value {v!r}")
    quantile_summary = {}
    for key, st in hists.items():
        n = st.get("count", 0)
        bsum = st.get("zero_count", 0) + sum(st.get("buckets", {}).values())
        if n != bsum:
            raise ValueError(
                f"histogram {key}: count {n} != bucket sum {bsum}")
        if any(c <= 0 for c in st.get("buckets", {}).values()):
            raise ValueError(f"histogram {key}: non-positive bucket count")
        if n > 0:
            h = LogHistogram(st.get("growth", DEFAULT_GROWTH))
            h.count = n
            h.zero_count = st["zero_count"]
            h.min = st["min"]
            h.max = st["max"]
            h.total = st["sum"]
            h.buckets = {int(i): c for i, c in st["buckets"].items()}
            p50, p90, p99 = h.quantiles((0.5, 0.9, 0.99))
            eps = 1e-9 + 1e-9 * abs(st["max"])
            ordered = (st["min"] - eps <= p50 <= p90 + eps
                       and p90 <= p99 + eps <= st["max"] + 2 * eps)
            if not ordered:
                raise ValueError(
                    f"histogram {key}: quantiles not ordered within "
                    f"[min, max]: min={st['min']} p50={p50} p90={p90} "
                    f"p99={p99} max={st['max']}")
            if not math.isfinite(st["sum"]):
                raise ValueError(f"histogram {key}: non-finite sum")
            quantile_summary[key] = {"p50": p50, "p90": p90, "p99": p99}
    all_keys = list(counters) + list(gauges) + list(hists)
    for name in require:
        if not any(name in k for k in all_keys):
            raise ValueError(
                f"required metric {name!r} not found among "
                f"{len(all_keys)} keys")
    return {
        "counters": len(counters),
        "gauges": len(gauges),
        "histograms": len(hists),
        "quantiles": quantile_summary,
        "request_log": doc.get("request_log", {}),
    }


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="validate a metrics snapshot")
    p.add_argument("--validate", required=True, metavar="SNAPSHOT.json")
    p.add_argument("--require", nargs="*", default=[],
                   help="metric names that must be present (substring)")
    args = p.parse_args(argv)
    try:
        info = validate_metrics_snapshot(args.validate,
                                         require=args.require)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"INVALID: {e}")
        return 1
    print(f"OK: {info['counters']} counters, {info['gauges']} gauges, "
          f"{info['histograms']} histograms, "
          f"request_log={info['request_log']}")
    for key, qs in sorted(info["quantiles"].items()):
        print(f"  {key}: p50={qs['p50']:.6g} p90={qs['p90']:.6g} "
              f"p99={qs['p99']:.6g}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
