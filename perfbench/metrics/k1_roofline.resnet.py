"""Per cent: K1's least time (work/resnet.py) over its device time in the trace."""
from perfbench.bench import readers


def read(ctx):
    return readers.roofline(ctx, "K1")
