"""One run of one cell: set-up, the measured window, the metrics, the check.

The window is a closed loop: batch ``i + 1`` is submitted once batch ``i``'s
answers are on the host.  No batch is submitted after ``seconds`` have
passed since the window opened, and the window closes when the last
submitted batch's answers arrive, so every rate is all the work of the
window over all of its time.  ``setup_s`` runs from the process's start to
the window's opening: building the kernels (in a checkout's first run),
making the weights and inputs, building the program and warming it up.

With ``trace`` the profiler records the window's first ``trace_batches``
batches; the per-layer metrics are read from that trace and from the
harness's spans.  Without it the end-to-end metrics are read, and nothing
is profiled.  Either way, once the window has closed, the peak memory of
the run so far (set-up and window) is read, the program's state is freed
and a sample of what the window produced is checked against the plain
reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from perfbench.bench import spec
from perfbench.bench.trace import WINDOW, Spans, TraceSummary, summarize


@dataclass
class WindowContext:
    """What an end-to-end metric's reader reads."""

    setup_s: float
    window_s: float
    units: int                 # work units completed (images, tokens)
    latencies_s: List[float]   # one per request, submission to answer on the host


@dataclass
class TraceContext:
    """What a per-layer metric's reader reads."""

    trace: TraceSummary
    batches: List[dict]                  # the traced batches, as the system describes them
    least: List[Dict[str, float]]        # their least times by kernel id, and "useful"
    spans: Dict[str, List[float]]        # host timings by name
    counters: Dict[str, int] = field(default_factory=dict)


def _profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: torch.device, *,
             t0: float, root: Path = spec.ROOT, bench: Optional[dict] = None,
             config: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[dict] = None, log=print) -> dict:
    """The result line of one run (see ``perfbench/run.py``).  ``config``,
    ``traffic`` and ``limits`` replace the cell's files (tests)."""
    bench = bench if bench is not None else spec.load_benchmark(root)
    cell = spec.by_name(bench["workloads"], cell_name, "workload")
    config = config if config is not None else spec.config_of(bench, cell, root)
    traffic = traffic if traffic is not None else spec.traffic_of(cell, root)
    limits = limits if limits is not None else spec.limits_of(cell_name, root)

    spans = Spans(trace)
    system = spec.system(config["system"]).System(config, traffic, seed, device, spans)
    t_setup = time.perf_counter()
    system.setup()
    _sync(device)
    log(f"set-up: {t_setup - t0:.3f} s to the system's own (imports, CUDA context), "
        f"{time.perf_counter() - t_setup:.3f} s in it (weights, inputs, program, warm-up)")

    traced: List[int] = []
    if trace:
        prof = _profile(device)
        prof.__enter__()
        spans.profiling = True
        window = torch.profiler.record_function(WINDOW)
        window.__enter__()

    def stop_profile():
        _sync(device)
        window.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        spans.profiling = False

    setup_s = time.perf_counter() - t0
    records = []
    start = time.perf_counter()
    i = 0
    while True:
        sub = time.perf_counter()
        with spans.span("perfbench.batch"):
            out = system.call(i)
        done = time.perf_counter()
        records.append((i, sub, done))
        system.observe(i, out)
        if spans.profiling:
            traced.append(i)
            if len(traced) == traffic["trace_batches"]:
                stop_profile()
        i += 1
        if done - start >= seconds:
            break
    window_s = records[-1][2] - start
    if spans.profiling:
        stop_profile()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    metrics = {}
    extra: Dict[str, Any] = {}
    names = spec.metrics_of(bench, cell_name, trace)
    if trace:
        summary = summarize(prof)
        batches = [system.traced_batch(j) for j in traced]
        ctx = TraceContext(summary, batches, [system.least_s(config, b) for b in batches],
                           spans.values, system.counters())
        extra = {"busy_s": summary.busy_s, "window_s": summary.window_s}
    else:
        lat = [done - sub for j, sub, done in records for _ in system.requests(j)]
        ctx = WindowContext(setup_s, window_s, sum(sum(system.requests(j)) for j, _, _ in records), lat)
    for m in names:
        value = spec.reader(m["name"], root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    attempted = sum(len(system.requests(j)) for j, _, _ in records)
    log(f"window: {len(records)} batches, {attempted} requests in {window_s:.3f} s; set-up {setup_s:.3f} s; "
        f"peak {peak} B")
    system.release()
    checks = system.check(limits)
    correct = all(c["value"] <= c["limit"] for c in checks)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": 1, "memory_peak_bytes": peak, **extra}
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = summary.breakdown()
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"], "compared": c["compared"]}
                        for c in checks}
    return result
