"""90th percentile (nearest rank) of time to first token over every
request due in the window, from when it was due (queue wait included); a
request shed or unfinished counts as waiting until the run's end."""
from portbench import stats


def read(ctx):
    return stats.ttft_ms(ctx.recs, 90, ctx.t_end)
