"""The one traffic generator: a mix file of ``traffic/`` plus a seed gives
the requests of a run.

The mix's own ``schedule_seed`` draws the set of requests that every run
sends: each request's prompt and answer lengths, drawn independently,
each log-uniform between the mix's bounds, and, open loop, the arrival
times. The run's seed draws the prompt tokens, a closed loop's order
(and, elsewhere, the weights). A schedule drawn by the run's seed would
change the work from seed to seed: the tail of an open loop's time to
first token turns on where the bursts and the longest prompts fall.

- Closed loop (``"loop": "closed"``): one client sends a pool of
  ``round(requests_per_s * seconds)`` requests one after another, and
  every one of them finishes.
- Open loop (``"loop": "open"``): ``n = round(rate_per_s * seconds)``
  requests arrive as a Poisson process given that n of its arrivals fall
  within the window: n + 1 independent exponential gaps, scaled to span
  the window, the last of them after the last arrival.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

#: ids drawn for prompt tokens start here (0-2 are left to special tokens)
FIRST_TOKEN = 3


@dataclasses.dataclass
class Request:
    """A request as ``ContinuousBatcher.run`` takes it."""

    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0
    session: Optional[str] = None


def sizes(mix: dict, n: int) -> List[tuple]:
    """The mix's first n (prompt, answer) lengths: row i is the same
    whatever n is."""
    u = np.random.default_rng([int(mix["schedule_seed"]), 0]).random((n, 2))
    out = []
    for col, key in enumerate(("prompt_len", "answer_len")):
        lo, hi = (int(x) for x in mix[key])
        out.append(np.rint(lo * (hi / lo) ** u[:, col]).astype(int))
    return [(int(p), int(a)) for p, a in zip(*out)]


class Traffic:
    """The requests of one run, from a mix and a seed."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = seed % (1 << 63)
        self.rng = np.random.default_rng([self.seed, 1])

    def _requests(self, order: Sequence[int], arrivals: Sequence[float]
                  ) -> List[Request]:
        pairs = sizes(self.mix, len(order))
        out = []
        for uid, (j, t) in enumerate(zip(order, arrivals)):
            plen, alen = pairs[j]
            prompt = self.rng.integers(FIRST_TOKEN, self.vocab, size=plen,
                                       dtype=np.int64).astype(np.int32)
            out.append(Request(uid, prompt, alen, float(t)))
        return out

    def open_loop(self, seconds: float) -> List[Request]:
        """The requests due within a window of ``seconds``."""
        n = max(1, int(round(float(self.mix["rate_per_s"]) * seconds)))
        g = np.random.default_rng([int(self.mix["schedule_seed"]), 1]) \
            .exponential(1.0, n + 1)
        return self._requests(range(n), np.cumsum(g)[:n] * (seconds / g.sum()))

    def closed_loop(self, seconds: float) -> List[Request]:
        """The pool one client sends, in the order it sends them."""
        n = max(1, int(round(float(self.mix["requests_per_s"]) * seconds)))
        order = np.random.default_rng([self.seed, 2]).permutation(n)
        return self._requests(order, [0.0] * n)

    def warmup(self, n: int = 1) -> List[Request]:
        """Requests that reach the mix's longest prompt (and its chunk
        and decode shapes), of a few tokens each, drawn apart from the
        measured ones."""
        plen = int(self.mix["prompt_len"][1])
        rng = np.random.default_rng([self.seed, 4])
        out = []
        for i in range(n):
            prompt = rng.integers(FIRST_TOKEN, self.vocab, size=plen,
                                  dtype=np.int64).astype(np.int32)
            out.append(Request(-1 - i, prompt, 4, 0.0))
        return out
