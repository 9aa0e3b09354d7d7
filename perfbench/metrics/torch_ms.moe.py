"""Device ms a batch in operations that are not the port's kernels (the routing glue among them)."""
from perfbench.bench import readers


def read(ctx):
    return readers.torch_ms(ctx)
