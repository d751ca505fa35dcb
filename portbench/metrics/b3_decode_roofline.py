"""B3's decode path (q4 projections at M = the decode rows): the bounds
of its calls in the traced window (``counts/b3_decode.py``) over their
device time (the main kernel and its split combine), in %."""
from portbench import readers


def read(ctx):
    return readers.b3_roofline(ctx, "decode")
