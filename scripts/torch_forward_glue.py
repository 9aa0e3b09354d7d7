#!/usr/bin/env python3
"""Where the PyTorch port's RESNET18 forward spends its device time, for one
source tree, so that two trees can be compared in one run on one card.

Run from the repository root on a machine with one CUDA card::

    python3 scripts/torch_forward_glue.py [--src DIR] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (default:
this checkout's); its kernels build into that tree's ``build/``.  The script
runs RESNET18 at batch 32 (random weights from seed 0, as ``chip_smoke.py``
does) and prints one JSON object:

* the forward's median and p80 over 50 eager forwards, each between CUDA
  events, and the median host time to enqueue one forward (from an idle
  card to the return of the call, before its device work ends): near the
  forward's time, the forward is host-bound;
* from ``torch.profiler`` over 3 forwards: device busy time, PyTorch's copies
  (``aten::copy_`` ops) and all of PyTorch's kernels (glue) per forward, with
  launches and device time, and the port's kernels by name;
* the relu, add and pool-sum wrapper calls of one forward, each at the operands
  the forward hands it (layout kept), summed over the forward in CUDA-graph
  replay: what the path pays for them, any copy inside the wrapper included.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEED, FORWARDS, PROFILED = 32, 0, 50, 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to import repro_torch from")
    ap.add_argument("--label", default="checkout")
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_forward_glue: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # its timing and profiling helpers

    sys.path.insert(0, str(Path(args.src).resolve()))  # ahead of the checkout's own src
    from repro_torch.kernels import _build, conv, ewise
    from repro_torch.models import resnet

    _build.build_all()
    dev = torch.device("cuda", 0)
    cfg = resnet.RESNET18
    params = resnet.init_params(cfg, SEED, device="cpu")
    x = resnet.make_input(cfg, BATCH, seed=SEED + 1, device="cpu").to(dev)
    model = resnet.ResNet(cfg, params, device=dev)

    calls = {"relu": [], "ewise_add": [], "pool_sum": []}
    orig_ewise, orig_pool = ewise._ewise, conv._pool_rows

    def rec_ewise(op, a, b=None):
        calls["ewise_add" if op == "add" else "relu"].append(
            lambda op=op, a=a.clone(), b=None if b is None else b.clone(): ewise._ewise(op, a, b))
        return orig_ewise(op, a, b)

    def rec_pool(p, op):
        calls[f"pool_{op}"].append(lambda op=op, p=p.clone(): conv._pool_rows(p, op))
        return orig_pool(p, op)

    ewise._ewise, conv._pool_rows = rec_ewise, rec_pool
    try:
        with torch.no_grad():
            model(x)
    finally:
        ewise._ewise, conv._pool_rows = orig_ewise, orig_pool
    torch.cuda.synchronize()

    fwd = cs.forward_samples(torch, lambda: model(x), FORWARDS)
    enqueue = []
    for _ in range(FORWARDS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model(x)
        enqueue.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    _, kernels, (copies, copy_ms) = cs.device_profile(torch, lambda: model(x), PROFILED)

    def per_forward(items):
        return {"launches": sum(c for c, _ in items) / PROFILED, "device_ms": sum(ms for _, ms in items) / PROFILED}

    result = {
        "label": args.label, "src": args.src, "gpu": cs.nvidia_smi("name,power.limit"), "batch": BATCH,
        "forward_ms_median": cs.median(fwd), "forward_ms_p80": fwd[int(0.8 * len(fwd)) - 1],
        "forward_ms_min": fwd[0], "forward_ms_max": fwd[-1], "host_enqueue_ms_median": cs.median(sorted(enqueue)),
        "device_busy_ms_per_forward": sum(ms for _, ms in kernels.values()) / PROFILED,
        "copies_per_forward": {"launches": copies / PROFILED, "device_ms": copy_ms / PROFILED},
        "glue_per_forward": per_forward([v for n, v in kernels.items() if cs.is_glue(n)]),
        "port_kernels_per_forward": {n: per_forward([v]) for n, v in kernels.items() if not cs.is_glue(n)},
        "wrapper_graph_ms_per_forward": {k: sum(cs.graph_ms(torch, fn) for fn in fns) for k, fns in calls.items()},
        "wrapper_calls_per_forward": {k: len(v) for k, v in calls.items()},
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
