"""Images whose logits reached the host in the window, over the window."""
from perfbench.bench import readers


def read(ctx):
    return readers.rate(ctx)
