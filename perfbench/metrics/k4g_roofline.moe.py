"""Per cent: K4G's least time (work/mla_moe.py) over its device time in the trace."""
from perfbench.bench import readers


def read(ctx):
    return readers.roofline(ctx, "K4G")
