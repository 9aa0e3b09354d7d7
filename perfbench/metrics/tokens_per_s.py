"""Prompt tokens (padding not counted) and generated tokens of every request completed in the window, over the window."""
from perfbench.bench import readers


def read(ctx):
    return readers.rate(ctx)
