"""Device ms a batch in operations that are not the port's kernels. One image a call."""
from perfbench.bench import readers


def read(ctx):
    return readers.torch_ms(ctx)
