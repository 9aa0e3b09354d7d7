"""Median host us of the harness's span around the call into the Executor, to its return."""
from perfbench.bench import readers


def read(ctx):
    return readers.median_us(ctx, "executor_call_s")
