"""Per cent: the forward's useful int8 operations at the int8 peak over the traced window."""
from perfbench.bench import readers


def read(ctx):
    return readers.mfu(ctx)
