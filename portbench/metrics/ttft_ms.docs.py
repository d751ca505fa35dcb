"""Mean time to first token from each request's send (closed loop): the
prefill of a long prompt. With 15-25 requests in a window a tail is not
supported, so this stays a per-layer reading."""
from portbench import stats


def read(ctx):
    return stats.mean_ttft_ms(ctx.recs)
