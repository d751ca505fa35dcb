"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI)
over seconds of the measured window, reduced to the kernels
and copies that ran, the busy time, and a breakdown of device time by
operation and of idle time by what the harness was doing on the host.

Only device activity is recorded (no CPU operators), and the events are
read from the profiler's raw results, so a window of millions of kernels
stays cheap to reduce."""
from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Kernel = Tuple[str, float, float]        # (name, start s, duration s)


def short_name(name: str) -> str:
    """A kernel's demangled name without its argument list, return type
    and anonymous namespaces (template arguments kept)."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            return name[:i]
    return name


def template_args(name: str) -> List[str]:
    """The top-level template arguments of ``kernel<a, b, ...>(...)``."""
    s = short_name(name)
    i = s.find("<")
    if i < 0 or not s.endswith(">"):
        return []
    inner, out, depth, cur = s[i + 1:-1], [], 0, ""
    for ch in inner:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    out.append(cur.strip())
    return out


def union_s(intervals: Sequence[Tuple[float, float]]) -> Tuple[float, list]:
    """(total length, merged intervals) of (start, end) intervals."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


class DeviceTrace:
    """``torch.profiler`` over the last ``seconds`` before a close: armed
    with the bounds, it starts at the first step boundary past (close -
    seconds) and stops at the first one past the close. Events are read
    once the run is over (``finish``)."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof = None
        self.t0 = self.t1 = None
        self.start_at = self.stop_at = None
        self.kernels: List[Kernel] = []
        #: seconds the profiler took to start, to stop and to be read
        self.cost_s = 0.0

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises CUPTI, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def arm(self, t_open: float, t_close: float):
        self.start_at = max(t_open, t_close - self.seconds)
        self.stop_at = t_close

    def tick(self, now: float) -> None:
        if self.start_at is None:
            return
        if self.t0 is None and now >= self.start_at:
            self.start()
        elif self.t0 is not None and self.t1 is None \
                and now >= self.stop_at:
            self.stop()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        # kineto's timestamps are epoch nanoseconds; the harness's spans
        # are perf_counter seconds
        self._off_ns = time.time_ns() - time.perf_counter_ns()
        self.t0 = time.perf_counter()
        self.cost_s += self.t0 - t

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.cost_s += time.perf_counter() - self.t1

    def finish(self) -> None:
        """Stop if still running, and keep the device events of the
        traced window."""
        if self.prof is None:
            return
        if self.t1 is None:
            self.stop()
        t = time.perf_counter()
        lo, hi = self.t0, self.t1
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            start = (e.start_ns() - self._off_ns) * 1e-9
            dur = e.duration_ns() * 1e-9
            if start + dur < lo or start > hi:
                continue
            out.append((e.name(), start, dur))
        out.sort(key=lambda k: k[1])
        self.kernels = out
        self.prof = None
        self.cost_s += time.perf_counter() - t

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> Tuple[float, list]:
        lo, hi = self.t0, self.t1
        return union_s([(max(s, lo), min(s + d, hi))
                        for _, s, d in self.kernels if s + d > lo and s < hi])

    def breakdown(self, spans: Sequence[Tuple[str, float, float]],
                  top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time
        summed by the harness span the host was in (the innermost span
        holding the gap's midpoint; none: outside the engine)."""
        by_op: Dict[str, float] = defaultdict(float)
        for name, _, d in self.kernels:
            by_op[short_name(name)] += d
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        _, merged = self.busy()
        edges = [self.t0] + [x for ab in merged for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = sorted(spans, key=lambda s: s[1])
        idle: Dict[str, float] = defaultdict(float)
        count: Dict[str, int] = defaultdict(int)
        i, open_ = 0, []
        for a, b in gaps:                       # in time order
            mid = 0.5 * (a + b)
            while i < len(spans) and spans[i][1] <= mid:
                open_.append(spans[i])
                i += 1
            open_ = [sp for sp in open_ if sp[2] >= mid]
            label = max(open_, key=lambda sp: sp[1])[0] if open_ \
                else "outside the engine"
            idle[label] += b - a
            count[label] += 1
        gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[f"{n} ({count[n]} gaps)", s]
                              for n, s in gaps_out]}


def calls(kernels: Sequence[Kernel], main: str, follow: str,
          keep=None) -> List[Tuple[str, float]]:
    """The calls of a kernel that launches ``main`` and, where it splits,
    a ``follow`` kernel next on the stream: [(main's name, device s of
    both)]. ``keep(name)`` selects the main kernels that count."""
    out: List[list] = []
    last = None
    for name, _, d in kernels:
        s = short_name(name)
        if s.startswith(main):
            last = [name, d] if keep is None or keep(name) else None
            if last is not None:
                out.append(last)
        elif s.startswith(follow):
            if last is not None:
                last[1] += d
            last = None
        # other kernels between a main and its follow do not break it
    return [(n, d) for n, d in out]
