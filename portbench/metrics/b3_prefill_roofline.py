"""B3's tile path (q4 projections at M = the prompt's rows): the bounds
of its calls in the traced window (``counts/b3_tile.py``) over their
device time, in %."""
from portbench import readers


def read(ctx):
    return readers.b3_roofline(ctx, "tile")
