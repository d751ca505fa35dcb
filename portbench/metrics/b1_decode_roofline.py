"""B1 (paged decode attention): the bounds of its calls in the traced
window, bytes from each step's real lengths (``counts/b1_decode.py``),
over their device time (design 2's kernel and its split combine), in %."""
from portbench import readers


def read(ctx):
    return readers.b1_roofline(ctx)
