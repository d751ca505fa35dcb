"""The traced window's model work at the chip's peak: each prefill and
decode step's least time (the larger of its operations over 989 TFLOP/s
and its bytes, weights read once a step plus the KV lines read and
written, over 3.35 TB/s), summed, over the window's wall time, in %."""
from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
