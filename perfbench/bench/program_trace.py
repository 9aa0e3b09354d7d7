"""The port's own spans in the profile of a traced window, and what the
per-layer readings of the program's layers take from them.

With span recording on (``repro_torch.obs.enable()``) every span of the port
is also a profiler range named ``repro_torch.<name>`` while the profiler
records (``repro_torch/obs.py`` lists the spans).  :func:`attribute` splits
the window by those ranges, on two rules:

* an idle gap of the device goes to the innermost ``repro_torch.`` range, on
  the window's thread, around the gap's midpoint; the other host events
  (aten ops, CUDA runtime calls, the harness's own spans) are skipped;
* a device operation goes to the innermost ``repro_torch.`` range around the
  host call that launched it: the runtime call (``cudaLaunchKernel``,
  ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...) with the operation's
  correlation id.

The host time of a span is read from the port's own record
(``repro_torch.obs.record()``), which covers the whole window, and not from
the profile, which covers its first batches, each slowed by the profiler.
A range's shadow on the device's timeline (the profiler draws each range
over the operations it launched) is no operation, as in
:func:`perfbench.bench.trace.summarize`.  The functions at the end are the
readings: each returns None where the trace holds nothing to read.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from perfbench.bench.trace import WINDOW, _innermost, _merge

PREFIX = "repro_torch."
NONE = "(no program span)"
_HOST_NONE = "(no host span)"   # what trace._innermost names a point outside every range


@dataclass
class Event:
    """What the attribution reads of one event of the profile."""

    name: str
    start_us: float
    end_us: float
    device: bool = False      # on the device's timeline
    thread: int = 0
    corr: int = 0             # a runtime call's correlation id, shared by the operations it launched
    annotation: bool = False  # a range's shadow on the device's timeline

    @property
    def runtime(self) -> bool:
        """A CUDA runtime or driver call on the host."""
        return not self.device and self.name.startswith("cu")


@dataclass
class ProgramTrace:
    window_us: float
    ranges: List[Tuple[float, float, str]]                  # the window's ranges, names without the prefix
    idle_us: Dict[str, float] = field(default_factory=dict)    # idle µs by innermost range (NONE: none)
    device_us: Dict[str, float] = field(default_factory=dict)  # device µs by the range around the launch
    shadows: int = 0                                          # device events that are ranges' shadows

    def durations_us(self, name: str) -> List[float]:
        return [b - a for a, b, n in self.ranges if n == name]

    def idle_under(self, prefix: str) -> float:
        """Idle µs whose innermost range's name starts with ``prefix``."""
        return sum(us for n, us in self.idle_us.items() if n.startswith(prefix))


def events_of(prof) -> List[Event]:
    """The events of a ``torch.profiler`` profile."""
    from torch.autograd import DeviceType

    return [Event(e.name, e.time_range.start, e.time_range.end, e.device_type == DeviceType.CUDA, e.thread,
                  e.id, bool(getattr(e, "is_user_annotation", False))) for e in prof.events()]


def _shadow(e: Event) -> bool:
    return e.annotation or e.name.startswith((PREFIX, "perfbench."))


def attribute(events: List[Event], window: str = WINDOW) -> ProgramTrace:
    """Split the window (the harness's ``perfbench.window`` range) by the
    port's ranges: its idle gaps and its device operations, each to the
    innermost range the rules above give (NONE where there is none)."""
    spans = [e for e in events if e.name == window and not e.device]
    if not spans:
        raise RuntimeError("the profile holds no window span")
    w0, w1, thread = spans[0].start_us, spans[0].end_us, spans[0].thread
    ranges = sorted(((e.start_us, e.end_us, e.name[len(PREFIX):]) for e in events
                     if not e.device and e.thread == thread and e.name.startswith(PREFIX)
                     and e.end_us > w0 and e.start_us < w1), key=lambda r: (r[0], -r[1]))  # outer first
    device = [e for e in events if e.device and e.end_us > w0 and e.start_us < w1]
    ops = [e for e in device if not _shadow(e)]
    pt = ProgramTrace(w1 - w0, ranges, shadows=len(device) - len(ops))

    busy = _merge([(max(e.start_us, w0), min(e.end_us, w1)) for e in ops])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    for (a, b), name in zip(gaps, _innermost(ranges, [(a + b) / 2 for a, b in gaps])):
        name = NONE if name == _HOST_NONE else name
        pt.idle_us[name] = pt.idle_us.get(name, 0.0) + (b - a)

    launch = {e.corr: e.start_us for e in events if e.runtime and e.corr}
    at = sorted(((launch[e.corr], e) for e in ops if e.corr in launch), key=lambda te: te[0])
    pt.device_us[NONE] = sum(min(e.end_us, w1) - max(e.start_us, w0) for e in ops if e.corr not in launch)
    for (_, e), name in zip(at, _innermost(ranges, [t for t, _ in at])):
        name = NONE if name == _HOST_NONE else name
        pt.device_us[name] = pt.device_us.get(name, 0.0) + min(e.end_us, w1) - max(e.start_us, w0)
    return pt


# ---------------------------------------------------------------------------
# readings
# ---------------------------------------------------------------------------


def executor_host_us(call_us: List[float]) -> Optional[float]:
    """Median µs of an Executor call: ``call_us`` are the durations of the
    ``program.call`` spans the port recorded over the window (most of them
    outside the profiled batches, as the harness's ``replay_host_us``)."""
    return statistics.median(call_us) if call_us else None


def program_idle_us(pt: ProgramTrace, batches: int) -> Optional[float]:
    """Device-idle µs a traced batch whose innermost range is a ``program.*`` one."""
    if not batches or not pt.durations_us("program.call"):
        return None
    return pt.idle_under("program.") / batches


def engine_idle_ms(pt: ProgramTrace, batches: int) -> Optional[float]:
    """Device-idle ms a traced batch whose innermost range is a ``serve.*``
    one: under the engine's spans and no model or program span."""
    if not batches or not pt.durations_us("serve.run"):
        return None
    return pt.idle_under("serve.") / batches / 1e3


def device_ms(pt: ProgramTrace, name: str, batches: int) -> Optional[float]:
    """Device ms a traced batch in operations launched with ``name`` the
    innermost range (``model.act_quant``, ``model.dequant``, ``model.attention``)."""
    if not batches or name not in pt.device_us:
        return None
    return pt.device_us[name] / batches / 1e3


def engine_pad_share(counts: Dict[str, int]) -> Optional[float]:
    """Per cent of the prefill batches' ``tokens`` slots that are padding,
    from the engine's counters over the window."""
    slots = counts.get("serve.prompt_slots", 0)
    return 100.0 * counts.get("serve.padding_slots", 0) / slots if slots else None


def readings(pt: ProgramTrace, batches: int, counts: Dict[str, int],
             call_us: List[float]) -> Dict[str, Optional[float]]:
    """Every reading of the program's layers, by the metric it is for."""
    return {
        "executor_host_us": executor_host_us(call_us),
        "program_idle_us": program_idle_us(pt, batches),
        "engine_pad_share": engine_pad_share(counts),
        "engine_idle_ms": engine_idle_ms(pt, batches),
        "act_quant_ms": device_ms(pt, "model.act_quant", batches),
        "dequant_ms": device_ms(pt, "model.dequant", batches),
        "attention_ms": device_ms(pt, "model.attention", batches),
    }
