"""95th percentile over every request completed in the window of the time from its batch's submission to its first token on the host."""
from perfbench.bench import readers


def read(ctx):
    return readers.p95_ms(ctx)
