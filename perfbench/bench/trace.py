"""Spans of the harness's calls into the program, and the reading of the
profiler's trace of a window.

The harness records its spans with ``torch.profiler.record_function`` while
the profiler runs (so that the trace can say what the host did while the
device sat idle) and, in a traced run, the host time of chosen calls on its
own clock.  :func:`summarize` reduces a profile to what the per-layer
readers take: the traced window, the device operations in it and the
device's busy time.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.work import kernels

WINDOW = "perfbench.window"


class Spans:
    """The harness's spans and host timings of one run."""

    def __init__(self, tracing: bool):
        self.tracing = tracing      # a --trace 1 run
        self.profiling = False      # the profiler is recording
        self.values: Dict[str, List[float]] = {}

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.profiling else contextlib.nullcontext()

    def record(self, name: str, value: float) -> None:
        if self.tracing:
            self.values.setdefault(name, []).append(value)


@dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float

    @property
    def kernel(self) -> bool:
        """A kernel, and not a copy or a fill by the driver."""
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: List[DeviceOp]
    gaps_by_host: Dict[str, float] = field(default_factory=dict)

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for op in self.ops:
            out[op.name] = out.get(op.name, 0.0) + (op.end_us - op.start_us) / 1e6
        return out

    def kernel_seconds(self, kernel: Optional[str]) -> float:
        """Device seconds of the port's ``kernel`` (an id of
        ``work/port_kernels``), or with None of every operation that is not
        the port's."""
        return sum((op.end_us - op.start_us) / 1e6 for op in self.ops if kernels.kernel_of(op.name) == kernel)

    def kernel_count(self) -> int:
        return sum(1 for op in self.ops if op.kernel)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[short(n), s] for n, s in ops], "idle_gaps": [[short(n), s] for n, s in gaps]}


def short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _innermost(cpu: List[Tuple[float, float, str]], points: List[float]) -> List[str]:
    """For each of the sorted ``points``, the name of the shortest host span
    of ``cpu`` (one thread's, so nested or disjoint; sorted by start) that
    covers it, or ``"(no host span)"``."""
    out, stack, j = [], [], 0
    for p in points:
        while j < len(cpu) and cpu[j][0] <= p:
            while stack and stack[-1][1] < cpu[j][0]:
                stack.pop()
            stack.append(cpu[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no host span)")
    return out


def _annotation(event) -> bool:
    """A span's shadow on the device's timeline (the profiler draws each
    ``record_function`` range over the kernels it launched): no operation."""
    return getattr(event, "is_user_annotation", False) or event.name.startswith("perfbench.")


def summarize(prof) -> TraceSummary:
    """The traced window (the harness's ``perfbench.window`` span), the
    device operations inside it, the union of their intervals, and the idle
    gaps between them summed by the host span that covered each gap."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not window:
        raise RuntimeError("the profile holds no window span")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    thread = window[0].thread
    ops = [DeviceOp(e.name, max(e.time_range.start, w0), min(e.time_range.end, w1))
           for e in events if e.device_type == DeviceType.CUDA and not _annotation(e)
           and e.time_range.end > w0 and e.time_range.start < w1]
    busy = _merge([(o.start_us, o.end_us) for o in ops])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    cpu = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CPU and e.thread == thread and e.name != WINDOW)
    by_host: Dict[str, float] = {}
    names = _innermost(cpu, [(a + b) / 2 for a, b in gaps])
    for (a, b), name in zip(gaps, names):
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
    return TraceSummary((w1 - w0) / 1e6, sum(b - a for a, b in busy) / 1e6, ops, by_host)
