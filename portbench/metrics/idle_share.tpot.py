"""The share of the traced window in which no kernel or copy ran on the
card (torch.profiler), in %."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
