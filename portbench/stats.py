"""Exact percentiles and rates over a run's request records (host clock,
seconds). A record has ``due`` (when the request was due: its arrival
open loop, its send closed loop), ``admit`` (start of its successful
admit), ``first`` (its first token existed), ``finish`` and ``tokens``
(tokens generated); a request that was shed or never finished has
``first`` or ``finish`` None."""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Rec:
    uid: int
    prompt_len: int
    max_new: int
    due: float
    admit: Optional[float] = None
    first: Optional[float] = None
    finish: Optional[float] = None
    tokens: int = 0


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank: a value of the
    sample, the ceil(q n / 100)-th smallest."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    k = max(1, math.ceil(q * len(v) / 100.0))
    return v[k - 1]


def tpot_ms(recs: Iterable[Rec], t_end: float) -> Optional[float]:
    """Time between output tokens: over the requests finished by
    ``t_end``, the sum of (finish - first token) over the sum of (tokens
    - 1)."""
    span = n = 0.0
    for r in recs:
        if r.finish is not None and r.finish <= t_end and r.tokens > 1:
            span += r.finish - r.first
            n += r.tokens - 1
    return 1e3 * span / n if n else None


def ttft_ms(recs: Iterable[Rec], q: float, t_missing: float
            ) -> Optional[float]:
    """The q-th percentile of time to first token from when each request
    was due; a request with no first token counts as waiting until
    ``t_missing`` (the end of the run)."""
    vals = [(r.first if r.first is not None else t_missing) - r.due
            for r in recs]
    return 1e3 * nearest_rank(vals, q) if vals else None


def tokens_per_s_open(events: Sequence[Tuple[float, int]], t0: float,
                      seconds: float) -> float:
    """Every token generated within [t0, t0 + seconds], over the window."""
    n = sum(k for t, k in events if t0 <= t <= t0 + seconds)
    return n / seconds


def tokens_per_s_closed(recs: Iterable[Rec], t0: float) -> Optional[float]:
    """The tokens of the completed requests over the time from the
    window's start to the last completion."""
    done = [r for r in recs if r.finish is not None]
    if not done:
        return None
    return sum(r.tokens for r in done) / (max(r.finish for r in done) - t0)


def queue_wait_ms(recs: Iterable[Rec], q: float, t_missing: float
                  ) -> Optional[float]:
    """The q-th percentile of due to the start of the admit that took the
    request (a request never admitted waits until ``t_missing``)."""
    vals = [(r.admit if r.admit is not None else t_missing) - r.due
            for r in recs]
    return 1e3 * nearest_rank(vals, q) if vals else None


def mean_ttft_ms(recs: Iterable[Rec]) -> Optional[float]:
    vals = [r.first - r.due for r in recs if r.first is not None]
    return 1e3 * sum(vals) / len(vals) if vals else None


def failed(recs: List[Rec]) -> int:
    return sum(1 for r in recs if r.finish is None)
