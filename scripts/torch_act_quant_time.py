#!/usr/bin/env python3
"""The activation quantize of the quantized linear on one CUDA card: the
one-pass kernel (``api.act_quant``) against the PyTorch chain it replaces
(``models.common._dynamic_act_quant``), at the shapes MiniCPM-2B's prefill
hands it.

Run from the repository root on a machine with one CUDA card::

    python3 scripts/torch_act_quant_time.py [--out FILE]

For each (M, K) bfloat16 activation it checks that the kernel's int8 values
and scales equal the chain's, then times each side as the median over
rounds of one replay of a CUDA graph of ``LAUNCHES`` back-to-back calls
between CUDA events, so that no host time enters (the inputs, 75 to 189 MB,
do not fit the 50 MB L2 cache), beside:

* the bound: the bytes one pass needs (the input read once, the int8 values
  and float32 scales written once) at 3.35 TB/s, and the share of it the
  kernel reaches;
* ``x.to(torch.int8)``, PyTorch's one-kernel cast that moves the same 3
  bytes an element, as a yardstick of what the card streams.

Prints one JSON object (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((16384, 2304), (16384, 5760), (8192, 2304), (4, 2304))
LAUNCHES, ROUNDS = 20, 7
HBM_BYTES_PER_S = 3.35e12


def time_ms(torch, fn) -> float:
    """Median ms a call over ROUNDS replays of a graph of LAUNCHES calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / LAUNCHES)
    return statistics.median(per_call)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_act_quant_time: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, api
    from repro_torch.kernels.act_quant import act_quant_bytes, act_quant_plan
    from repro_torch.models import common

    _build.build_all()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"card": card, "torch": torch.__version__, "launches": LAUNCHES, "rounds": ROUNDS, "shapes": []}
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k in SHAPES:
        x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(torch.bfloat16)
        got_q, got_s = api.act_quant(x, 8)
        want_q, want_s = common._dynamic_act_quant(x, 8)
        equal = bool(torch.equal(got_q, want_q) and torch.equal(got_s, want_s))
        bound_ms = act_quant_bytes(m, k, x.element_size()) / HBM_BYTES_PER_S * 1e3
        kernel_ms = time_ms(torch, lambda: api.act_quant(x, 8))
        chain_ms = time_ms(torch, lambda: common._dynamic_act_quant(x, 8))
        cast_ms = time_ms(torch, lambda: x.to(torch.int8))
        row = {"m": m, "k": k, "dtype": "bfloat16", "threads": act_quant_plan(k, x.dtype), "equal": equal,
               "kernel_ms": kernel_ms, "chain_ms": chain_ms, "cast_ms": cast_ms, "bound_ms": bound_ms,
               "kernel_share_of_bound": bound_ms / kernel_ms, "chain_over_kernel": chain_ms / kernel_ms}
        out["shapes"].append(row)
        print(json.dumps(row), file=sys.stderr)
        del x, got_q, got_s, want_q, want_s
    out["ok"] = all(r["equal"] for r in out["shapes"])
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
