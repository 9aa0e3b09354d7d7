"""Per cent of the traced window with no operation on the device."""
from perfbench.bench import readers


def read(ctx):
    return readers.idle_share(ctx)
