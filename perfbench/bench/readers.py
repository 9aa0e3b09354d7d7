"""Reductions that several metrics' readers share.  A reader returns None
where it finds nothing to read, never 0 for a share of a peak."""
from __future__ import annotations

import statistics
from typing import Optional

import numpy as np


def rate(ctx) -> Optional[float]:
    """Work units completed in the window over the window's seconds."""
    return ctx.units / ctx.window_s if ctx.window_s > 0 and ctx.units else None


def p95_ms(ctx) -> Optional[float]:
    """The 95th percentile of every request's latency, in ms (linear
    interpolation between order statistics)."""
    return float(np.percentile(ctx.latencies_s, 95)) * 1e3 if ctx.latencies_s else None


def idle_share(ctx) -> Optional[float]:
    """Per cent of the traced window in which no operation ran on the device."""
    t = ctx.trace
    if not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline(ctx, kernel: str) -> Optional[float]:
    """Per cent: ``kernel``'s least time over the traced batches (its work at
    the card's peaks) over its device time in the trace."""
    spent = ctx.trace.kernel_seconds(kernel)
    least = sum(b.get(kernel, 0.0) for b in ctx.least)
    return 100.0 * least / spent if spent > 0 and least > 0 else None


def mfu(ctx) -> Optional[float]:
    """Per cent: the traced batches' useful work, each kind at its peak, over
    the traced window."""
    useful = sum(b["useful"] for b in ctx.least)
    if not ctx.trace.ops or useful <= 0 or ctx.trace.window_s <= 0:
        return None
    return 100.0 * useful / ctx.trace.window_s


def torch_ms(ctx) -> Optional[float]:
    """Device ms a traced batch in operations that are not the port's
    kernels (PyTorch's kernels, copies and fills)."""
    if not ctx.trace.ops or not ctx.batches:
        return None
    return 1e3 * ctx.trace.kernel_seconds(None) / len(ctx.batches)


def kernels_per_batch(ctx) -> Optional[float]:
    if not ctx.trace.ops or not ctx.batches:
        return None
    return ctx.trace.kernel_count() / len(ctx.batches)


def median_us(ctx, name: str) -> Optional[float]:
    values = ctx.spans.get(name)
    return statistics.median(values) * 1e6 if values else None
