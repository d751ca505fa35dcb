"""Mean time of the engine's decode call (a CUDA-graph replay) over the
window's decode steps, synchronised before and after (traced run)."""
from portbench import readers


def read(ctx):
    return readers.decode_step_ms(ctx)
