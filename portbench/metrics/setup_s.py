"""Process start to the first measured request: imports, the weights made
on the card, the engine built, the cell's shapes warmed up and captured,
and, in a fresh checkout, the kernels built."""


def read(ctx):
    return ctx.setup_s
