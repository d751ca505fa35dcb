"""Runtime telemetry of the port: the shared clock and the do-nothing
tracer (``repro.runtime.telemetry``'s ``clock`` and ``NULL_TRACER``).

``clock`` is monotonic and high resolution; the engine stamps request
timings with it, the I/O policy its deadlines. ``NULL_TRACER`` takes every
call the JAX ``Tracer`` takes (spans, phases, counters, instants) and
records nothing, so instrumented code never branches on ``None``. The full
span tracer is not ported yet: ``resolve_tracer`` raises for any other
tracer.
"""
import contextlib
import time

clock = time.perf_counter


class _NullTracer:
    """A disabled tracer: every emission is a no-op."""

    enabled = False

    def span_event(self, name, t_start, t_end, **kw) -> None:
        pass

    def instant(self, name, **kw) -> None:
        pass

    def counter(self, name, value, **kw) -> None:
        pass

    def span(self, name, **kw):
        return contextlib.nullcontext()

    def phase(self, name, **kw):
        return contextlib.nullcontext()

    def token_step(self, index, **kw):
        return contextlib.nullcontext()


NULL_TRACER = _NullTracer()


def resolve_tracer(tracer):
    """``NULL_TRACER`` for ``None``; any real tracer raises until the span
    tracer is ported."""
    if tracer is None or tracer is NULL_TRACER:
        return NULL_TRACER
    raise NotImplementedError(
        "tracer= is not ported yet: the span tracer (ROADMAP Queue A "
        "item 7)")
