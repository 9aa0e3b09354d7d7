#!/usr/bin/env python3
"""Run one cell of the benchmark with the port's span recording on, and read
the program's layers from it.

    python3 perfbench/trace_program.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It is ``perfbench/run.py`` (same arguments,
same result line) with the port's spans (``repro_torch.obs``) recorded:

* ``--trace 1``: from the opening of the traced window to its close.  A
  second JSON line follows the result line: what
  :mod:`perfbench.bench.program_trace` reads from the profile (``readings``,
  by the metric each is for; the window's idle µs and device µs by innermost
  range; the shadows of ranges on the device's timeline) and the engine's
  counters over the window.
* ``--trace 0``: over the whole run, set-up and window, so that the result
  line's end-to-end metrics, beside those of ``perfbench/run.py`` on the
  same seed (recording off), show what leaving the recording on costs.

The second line also gives the spans the port's record kept and dropped, and
each span's count and median µs in it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def recording(harness):
    """While the block runs, each traced window of ``harness.run_cell``
    records the port's spans; yields a dict that holds, once the window has
    closed, its profile's events, the port's span record and the engine's
    counters over the window."""
    from perfbench.bench import program_trace
    from repro_torch import obs

    kept = {}
    profile, summarize = harness._profile, harness.summarize

    def opening(device):  # the window opens: the profiler starts, and the recording with it
        kept["counts"] = obs.counts("serve.")
        obs.enable()
        return profile(device)

    def closing(prof):  # the window has closed
        obs.disable()
        kept["record"] = obs.record()
        kept["counts"] = {k: n - kept["counts"].get(k, 0) for k, n in obs.counts("serve.").items()}
        kept["events"] = program_trace.events_of(prof)
        return summarize(prof)

    harness._profile, harness.summarize = opening, closing
    try:
        yield kept
    finally:
        harness._profile, harness.summarize = profile, summarize
        obs.disable()


def medians_us(durations) -> dict:
    """Each name's count and median µs, from (name, µs) pairs."""
    by = {}
    for name, us in durations:
        by.setdefault(name, []).append(us)
    return {name: [len(d), statistics.median(d)] for name, d in sorted(by.items())}


def recorded_us(record):
    return [(s.name, (s.end_ns - s.start_ns) / 1e3) for s in record.spans]


def program_line(kept) -> dict:
    """The second line of a traced run, from what :func:`recording` kept:
    the readings, and each span's median µs in the profiled batches and in
    the port's record of the window."""
    from perfbench.bench import program_trace

    events = kept["events"]
    pt = program_trace.attribute(events)
    batches = sum(1 for e in events if e.name == "perfbench.batch" and not e.device)
    calls = [us for name, us in recorded_us(kept["record"]) if name == "program.call"]

    def top(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:12])

    return {"batches": batches, "readings": program_trace.readings(pt, batches, kept["counts"], calls),
            "counts": kept["counts"], "shadows": pt.shadows, "window_us": pt.window_us,
            "idle_us": top(pt.idle_us), "device_us": top(pt.device_us),
            "profiled_span_us": medians_us((n, b - a) for a, b, n in pt.ranges)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    import run  # perfbench/run.py, beside this file

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.bench import harness
    from repro_torch import obs

    run.T0 = T0
    sys.argv = [sys.argv[0], "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace)]
    if args.trace:
        with recording(harness) as kept:
            rc = run.main()
        out = program_line(kept) if rc == 0 else {}
    else:
        obs.enable()
        rc = run.main()
        obs.disable()
        out = {}
    rec = obs.record()
    out.update(spans=len(rec.spans), dropped=rec.dropped, span_us=medians_us(recorded_us(rec)))
    print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
