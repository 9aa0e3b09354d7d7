#!/usr/bin/env python3
"""Where a held Executor's graph replay spends its time, on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/torch_executor_replay_cost.py

For the decode step's Program at 4096 and 32768 rows (Qwen2-0.5B's attention
width, as ``chip_smoke.py`` phase 3e) and one decode GEMV (896 × 896 int8),
it reads, median of 200 each:

* the host time of each piece of ``Executor.__call__`` on the graph route,
  each piece alone and back to back without a synchronise (the enqueue cost):
  flattening and checking the arguments, choosing the route, the copy-in
  (``torch._foreach_copy_``), the graph launch, the output clones and the
  launch bookkeeping, and the whole call;
* the latency of the whole call from an idle card (host clock, synchronised),
  by graph replay and by eager replay.

It prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

REPS = 200


def host_us(torch, fn, reps=REPS):
    """Median host time in µs of one ``fn()``, calls back to back (a
    synchronise every 20 calls keeps the queue short)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    out = []
    for i in range(reps):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e6)
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return sorted(out)[len(out) // 2]


def latency_us(torch, fn, reps=REPS):
    """Median µs of one ``fn()`` from an idle card to the end of its work."""
    for _ in range(5):
        fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e6)
    return sorted(out)[len(out) // 2]


def pieces(torch, api, program, ex, args):
    """Host µs of each piece of a graph-route call of ``ex(*args)``."""
    leaves, _ = program.tree_flatten((args, {}))
    ex(*args)
    ex(*args)
    (replay,) = [r for r in ex._graphs.values() if isinstance(r, program._GraphReplay)]
    return {
        "flatten_and_check": host_us(torch, lambda: (program.tree_flatten((args, {})),
                                                     tuple(program._aval_of(x) for x in leaves))),
        "route": host_us(torch, lambda: program._graph_device(leaves, ex.program.consts)),
        "copy_in": host_us(torch, lambda: torch._foreach_copy_(replay.inputs, leaves)),
        "graph_launch": host_us(torch, replay.graph.replay),
        "clone_outputs": host_us(torch, lambda: [o.clone() for o in replay.outputs]),
        "launch_bookkeeping": host_us(torch, lambda: api.replay_launches(replay.log)),
        "whole_call": host_us(torch, lambda: ex(*args)),
        "latency_graph": latency_us(torch, lambda: ex(*args)),
        "latency_eager": latency_us(torch, lambda: ex._eager(leaves)),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_executor_replay_cost: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import api, program
    from repro_torch.serve import pimsab_step

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8).to(dev)

    cfg = pimsab_step.AttnServeConfig(**cs.DECODE_CFG)
    d = cs.DECODE_CFG["head_dim"]
    out = {"gpu": cs.nvidia_smi("name,power.limit"), "reps": REPS, "paths": {}}
    for cap in (4096, cs.DECODE_CAPACITY):
        onehot = torch.zeros(cap, dtype=torch.int8, device=dev)
        onehot[cap - 1] = 1
        args = (i8((cap, d)), i8((cap, d)), i8((1, d)), i8((d,)), i8((d,)), onehot)
        ex = api.compile(pimsab_step.decode_program(cfg, cap))
        out["paths"][f"decode_step_{cap}"] = pieces(torch, api, program, ex, args)
    w, x = i8((896, 896)), i8((896,))
    ex = api.compile(api.trace(api.decode_gemv, name="gemv_896").program_for(w, x))
    out["paths"]["decode_gemv_896x896"] = pieces(torch, api, program, ex, (w, x))
    print(out["gpu"])
    for name, p in out["paths"].items():
        print(f"{name}: " + ", ".join(f"{k} {v:.2f} us" for k, v in p.items()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
