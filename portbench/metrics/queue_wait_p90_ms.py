"""90th percentile (nearest rank) of each request's wait from when it was
due to the start of the admit that took it (the batcher's queue)."""
from portbench import stats


def read(ctx):
    return stats.queue_wait_ms(ctx.recs, 90, ctx.t_end)
