"""Output tokens over the measured time. Open loop: every token generated
within the window, over the window. Closed loop: the tokens of the
completed requests over the time from the window's start to the last
completion."""
from portbench import stats


def read(ctx):
    if ctx.loop == "open":
        return stats.tokens_per_s_open(ctx.events, ctx.t0, ctx.seconds)
    return stats.tokens_per_s_closed(ctx.recs, ctx.t0)
