"""Data substrate: byte-level tokenizer, synthetic corpus, request stream.

A copy of ``repro.data.pipeline`` (numpy only): the same seed gives the
same requests on both sides of the port.

Deterministic, host-shardable (each data-parallel host pulls its own slice
by ``(host_id, n_hosts)``), dependency-free. The synthetic corpus is a
mixture of Zipf-distributed "words" with Markov structure — enough signal
for a ~100M model's loss to fall measurably in a few hundred steps (the
end-to-end training example).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class ByteTokenizer:
    """UTF-8 bytes + specials. Vocab fits every assigned arch's table."""

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    def __init__(self, vocab: int = 259):
        assert vocab >= 256 + self.OFFSET
        self.vocab = vocab

    def encode(self, text: str, *, bos: bool = True, eos: bool = False
               ) -> List[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids) -> str:
        bs = bytes(max(0, int(i) - self.OFFSET) for i in ids
                   if int(i) >= self.OFFSET)
        return bs.decode("utf-8", errors="replace")


@dataclasses.dataclass
class SyntheticCorpus:
    """Zipf-Markov token stream with a fixed vocabulary."""

    vocab: int
    seed: int = 0
    n_states: int = 64
    branch: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # each state emits from a Zipf head and picks a next state
        self._emit = rng.integers(3, self.vocab,
                                  size=(self.n_states, self.branch))
        probs = 1.0 / np.arange(1, self.branch + 1) ** 1.2
        self._probs = probs / probs.sum()
        self._next = rng.integers(0, self.n_states,
                                  size=(self.n_states, self.branch))

    def stream(self, *, host_id: int = 0, n_hosts: int = 1,
               seed: Optional[int] = None) -> Iterator[int]:
        rng = np.random.default_rng((seed or self.seed) * n_hosts + host_id
                                    + 1)
        state = int(rng.integers(0, self.n_states))
        while True:
            j = int(rng.choice(self.branch, p=self._probs))
            yield int(self._emit[state, j])
            state = int(self._next[state, j])


def batches(corpus: SyntheticCorpus, batch: int, seq_len: int, *,
            host_id: int = 0, n_hosts: int = 1, seed: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    """Next-token-prediction batches: labels are tokens shifted by one."""
    streams = [corpus.stream(host_id=host_id * batch + i,
                             n_hosts=n_hosts * batch, seed=seed)
               for i in range(batch)]
    while True:
        chunk = np.array([[next(s) for _ in range(seq_len + 1)]
                          for s in streams], dtype=np.int32)
        yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int
    arrival_s: float
    session: Optional[str] = None   # multi-turn key for KV parking


class RequestGenerator:
    """Seeded arrival traces of variable-length prompts (serving
    benchmarks): Poisson (default) or bursty arrivals, prompt lengths
    drawn from a range or a discrete mix.

    ``lengths`` replaces the ``prompt_len`` range with a discrete choice
    set (e.g. ``(8, 16, 48)``) — serving benchmarks use this to mix
    short/long prompts while keeping the set of jitted prefill shapes
    small. ``pattern="bursty"`` releases requests in back-to-back groups
    of ``burst`` separated by ``burst_gap_s`` of silence — the adversarial
    arrival process for admission control (a Poisson trace rarely fills
    every slot at once; a burst always does).
    """

    def __init__(self, vocab: int, *, rate_per_s: float = 4.0,
                 prompt_len: Tuple[int, int] = (16, 256),
                 max_new: int = 64, seed: int = 0,
                 lengths: Optional[Tuple[int, ...]] = None):
        self.vocab = vocab
        self.rate = rate_per_s
        self.prompt_len = prompt_len
        self.lengths = lengths
        self.max_new = max_new
        self.rng = np.random.default_rng(seed)

    def generate(self, n: int, *, pattern: str = "poisson",
                 burst: int = 4, burst_gap_s: float = 0.25
                 ) -> List[Request]:
        if pattern not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival pattern {pattern!r}")
        t = 0.0
        out = []
        for i in range(n):
            if pattern == "poisson":
                t += self.rng.exponential(1.0 / self.rate)
            elif i > 0 and i % burst == 0:
                t += burst_gap_s       # whole burst shares one instant
            if self.lengths is not None:
                length = int(self.rng.choice(self.lengths))
            else:
                length = int(self.rng.integers(*self.prompt_len))
            prompt = self.rng.integers(3, self.vocab, size=length,
                                       dtype=np.int32)
            lo = max(1, min(8, self.max_new))
            out.append(Request(uid=i, prompt=prompt,
                               max_new_tokens=int(self.rng.integers(
                                   lo, self.max_new + 1)),
                               arrival_s=t))
        return out
