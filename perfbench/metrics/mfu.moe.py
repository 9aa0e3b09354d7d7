"""Per cent: the prefill's useful work over real tokens (the experts a token uses), each kind at its peak, over the traced window."""
from perfbench.bench import readers


def read(ctx):
    return readers.mfu(ctx)
