"""Drive the engine's ``ContinuousBatcher.run`` with a mix's requests and
time them on the host clock, around the benchmark's own calls into the
batcher: the engine's ``admit`` and ``step`` (and, in a traced run, its
``decode``, ``prefill_one`` and ``chunk_step`` callables) are wrapped on
the instance, so nothing of the program changes.

- Closed loop: one client sends a request, waits for its last token and
  sends the next, until its whole pool has finished; each request is its
  own ``run`` call, so its time to first token counts from its send.
- Open loop: every request due within the window goes to one
  ``run(respect_arrivals=True)``, which drains after the window closes;
  a request's times count from when it was due.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from .stats import Rec

now = time.perf_counter


class Overrun(RuntimeError):
    """The drain passed its deadline: the run stops, unfinished requests
    count as failed."""


class Recorder:
    def __init__(self, eng, *, traced: bool, trace=None,
                 deadline: Optional[float] = None):
        self.eng = eng
        self.traced = traced
        self.trace = trace
        self.deadline = deadline
        self.recs: Dict[int, Rec] = {}
        #: (host time, tokens generated at it)
        self.events: List[Tuple[float, int]] = []
        #: (name, start, end): the harness's spans, for the idle breakdown
        self.spans: List[Tuple[str, float, float]] = []
        #: traced run: (start, end, lengths after the step) a decode call
        self.decodes: List[Tuple[float, float, List[int]]] = []
        #: traced run: (start, end, rows, offset, rows with logits)
        self.prefills: List[Tuple[float, float, int, int, int]] = []
        self._wrap()

    # -- the wrappers ---------------------------------------------------- #

    def _wrap(self) -> None:
        eng = self.eng
        admit, step = eng.admit, eng.step

        def admit_w(cache, tokens, uid, prompt, max_new, session=None):
            rec = self.recs.get(uid)
            t0 = now()
            if rec is not None:
                rec.admit = t0
            out = admit(cache, tokens, uid, prompt, max_new,
                        session=session)
            t1 = now()
            self.spans.append(("admit", t0, t1))
            if rec is not None:
                rec.first = t1
                self.events.append((t1, 1))
            self._tick(t1)
            return out

        def step_w(cache, tokens):
            live = {eng.slots[i].uid for i in eng.active()}
            t0 = now()
            out = step(cache, tokens)
            t1 = now()
            self.spans.append(("step", t0, t1))
            n = sum(1 for u in live if u in self.recs)
            if n:
                self.events.append((t1, n))
            left = live - {eng.slots[i].uid for i in eng.active()}
            for u in left:
                if u in self.recs:
                    self.recs[u].finish = t1
            self._tick(t1)
            if self.deadline is not None and t1 > self.deadline:
                raise Overrun(f"drain past its deadline at {t1:.1f}")
            return out

        eng.admit, eng.step = admit_w, step_w
        if self.traced:
            self._wrap_traced()

    def _wrap_traced(self) -> None:
        eng = self.eng
        decode = eng.decode
        sync = torch.cuda.synchronize if eng.device.type == "cuda" \
            else (lambda: None)

        def decode_w(cache, tokens):
            lens = [self._prompt_len(eng.slots[i].uid)
                    + len(eng.slots[i].generated) for i in eng.active()]
            sync()
            t0 = now()
            out = decode(cache, tokens)
            sync()
            self.decodes.append((t0, now(), lens))
            return out
        eng.decode = decode_w
        if eng.prefill_chunk is None:
            prefill_one = eng.prefill_one

            def prefill_w(prompt):
                sync()
                t0 = now()
                out = prefill_one(prompt)
                sync()
                self.prefills.append((t0, now(), prompt.shape[1], 0, 1))
                return out
            eng.prefill_one = prefill_w
        else:
            chunk_step = eng.chunk_step

            def chunk_w(view, tokens, write=True):
                off = int(view["len"][0])
                sync()
                t0 = now()
                out = chunk_step(view, tokens, write)
                sync()
                S = tokens.shape[1]
                self.prefills.append((t0, now(), S, off, S))
                return out
            eng.chunk_step = chunk_w

    def _prompt_len(self, uid: int) -> int:
        rec = self.recs.get(uid)
        return rec.prompt_len if rec is not None else 0

    def _tick(self, t: float) -> None:
        if self.trace is not None:
            self.trace.tick(t)

    # -- records ----------------------------------------------------------- #

    def add(self, req, due: float) -> Rec:
        rec = Rec(req.uid, len(req.prompt), req.max_new_tokens, due)
        self.recs[req.uid] = rec
        return rec

    def collect(self) -> Dict[int, tuple]:
        """Fill each record's token count from the engine's finished list;
        returns uid -> (prompt, served tokens) of the finished requests."""
        done = {}
        for f in self.eng.finished:
            rec = self.recs.get(f.uid)
            if rec is not None and rec.finish is not None:
                rec.tokens = len(f.tokens)
                done[f.uid] = (None, list(f.tokens))
        return done


def closed_loop(eng, cache, rec: Recorder, requests, trace_s: float
                ) -> Tuple[float, float, Dict[int, object]]:
    """Send every request of the pool one after another, each when the
    one before has finished; a traced run records the first ``trace_s``
    seconds. Returns (window start, last completion, uid -> request)."""
    sent = {}
    t0 = now()
    if rec.trace is not None:
        rec.trace.arm(t0, t0 + trace_s)
        rec.trace.tick(t0)
    for req in requests:
        t = now()
        rec.add(req, t)
        sent[req.uid] = req
        eng.run(cache, [req])
        rec.spans.append(("run", t, now()))
        rec._tick(now())
    t_end = now()
    if rec.trace is not None:
        rec.trace.finish()
    return t0, t_end, sent


def open_loop(eng, cache, rec: Recorder, requests, seconds: float
              ) -> Tuple[float, float, Dict[int, object]]:
    """All requests to one ``run`` that replays their arrivals; returns
    (window start, end of the drain, uid -> request)."""
    t0 = now()
    if rec.trace is not None:
        rec.trace.arm(t0, t0 + seconds)
        rec.trace.tick(t0)
    sent = {}
    for req in requests:
        rec.add(req, t0 + req.arrival_s)
        sent[req.uid] = req
    try:
        eng.run(cache, list(requests), respect_arrivals=True,
                max_steps=1_000_000)
    except Overrun:
        pass
    t_end = now()
    if rec.trace is not None:
        rec.trace.finish()
    return t0, t_end, sent
