"""Device kernels (the port's and PyTorch's) a prefill batch in the trace."""
from perfbench.bench import readers


def read(ctx):
    return readers.kernels_per_batch(ctx)
