"""Per cent: the forward's useful int8 operations at the int8 peak over the traced window. One image a call."""
from perfbench.bench import readers


def read(ctx):
    return readers.mfu(ctx)
