"""Time between output tokens, token-weighted over the window's requests:
the sum over every request due in the window, once finished, of (finish
- first token), over the sum of (tokens - 1). Open loop, the requests
finish in the drain after the close too, so every run counts the same
requests. Host clock, taken by the benchmark around its calls."""
from portbench import stats


def read(ctx):
    return stats.tpot_ms(ctx.recs, ctx.t_end)
