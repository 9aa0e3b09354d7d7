#!/usr/bin/env python3
"""Moonlight-16B-A3B served whole on one CUDA card through the port's
normal path (``ServeEngine``), at its published sizes, against the
benchmark's plain reference (``perfbench/reference/mla_moe_int8.py``).

Run from the repository root on a machine with one CUDA card::

    python3 scripts/torch_moonlight_check.py [--seed N] [--batches N] [--out FILE]

1. The weights are drawn as the benchmark's system draws them
   (``perfbench/systems/mla_moe.py``, bfloat16 from the seed) and the
   engine quantizes them: peak device memory after each step.
2. The first batches of the ``prefill-512`` traffic (32 prompts of
   128-512 tokens, 1 new token) are served: each batch's host-clock ms
   (synchronised) and the launches of one prefill by kernel.
3. Prefill of 4 prompts of 64 tokens, then 3 decode steps through the
   latent cache, each step's logits against the reference's full forward
   over the 67 tokens at that position (relative L2 gap a row, the
   largest), the reference following the experts the program chose at each
   position and reporting its routing gap (``reference/mla_moe_int8.py``);
   beside it the gap to the reference routing on its own, and the int4-weight
   reference's gaps as the control.

Prints one JSON object (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2718281829)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()

    import numpy as np
    import torch

    from perfbench.bench import spec, traffic as tr
    from perfbench.reference import mla_moe_int8 as ref
    from perfbench.systems import mla_moe as sysm
    from repro_torch.kernels import api
    from repro_torch.serve.engine import Request, ServeEngine

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cfg = spec.load_json(ROOT / "perfbench" / "configs" / "moonlight-16b-a3b-int8.json")
    traffic = spec.load_json(ROOT / "perfbench" / "traffic" / "prefill-512.json")
    out = {"gpu": gpu, "torch": torch.__version__, "seed": args.seed}

    def gb():
        return torch.cuda.max_memory_allocated(dev) / 1e9

    t = time.perf_counter()
    raw = sysm.make_weights(cfg, args.seed, dev)
    torch.cuda.synchronize()
    out["drawn"] = {"s": time.perf_counter() - t, "peak_gb": gb()}
    t = time.perf_counter()
    mcfg = sysm.model_config(cfg)
    eng = ServeEngine(mcfg, sysm.port_tree(raw, cfg), max_len=traffic["cache_len"])
    del raw
    torch.cuda.synchronize()
    out["served_form"] = {"s": time.perf_counter() - t, "peak_gb": gb(),
                          "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9}
    print(json.dumps(out), flush=True)

    pool = tr.prompt_pool(traffic, cfg["vocab_size"], args.seed)
    b = traffic["batch"]
    batches = []
    with torch.no_grad():
        for i in range(args.batches + 1):
            reqs = [Request(rid=j, prompt=pool[i * b + j], max_new_tokens=1) for j in range(b)]
            api.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.run(reqs)
            torch.cuda.synchronize()
            batches.append({"ms": (time.perf_counter() - t) * 1e3, "tokens": sum(len(r.prompt) for r in reqs),
                            "padded": b * max(len(r.prompt) for r in reqs), "launches": api.launch_counts()})
    out["batches"] = batches[1:]  # the first builds the kernels
    out["serve_peak_gb"] = gb()
    print(json.dumps(out["batches"]), flush=True)

    # prefill and decode through the latent cache against the full forward
    from repro_torch.models import moe

    rng = np.random.default_rng(args.seed % 2**32)
    b, s, n = 4, 64, 3
    toks = torch.from_numpy(rng.integers(0, cfg["vocab_size"], (b, s + n))).to(dev)
    steps, chosen = [], []
    plain = moe.route_sigmoid

    def route(*a):
        weights, experts = plain(*a)
        chosen.append(experts.view(b, -1, experts.shape[-1]))
        return weights, experts

    moe.route_sigmoid = route
    with torch.no_grad():
        cache, logits = eng._prefill(eng.params, {"tokens": toks[:, :s].to(torch.int32)})
        steps.append(logits.float())
        for i in range(s, s + n):
            cache, logits = eng._decode(eng.params, cache, toks[:, i:i + 1].to(torch.int32))
            steps.append(logits.float())
    moe.route_sigmoid = plain
    del eng, cache
    torch.cuda.empty_cache()
    layers = len(chosen) // (n + 1)  # each expert layer at the prefill, then at each step
    routes = [torch.cat(chosen[j::layers], 1).reshape(-1, chosen[j].shape[-1]) for j in range(layers)]
    got = torch.stack(steps, 1)[..., : cfg["vocab_size"]]
    positions = list(range(s - 1, s + n))
    with torch.no_grad():
        q8 = ref.quantize_weights(sysm.make_weights(cfg, args.seed, dev), 8)
        want, _, gap = ref.logits_at(cfg, q8, toks, 8, positions, routes)
        own, _, _ = ref.logits_at(cfg, q8, toks, 8, positions)
        low, low_routes, _ = ref.logits_at(cfg, ref.quantize_weights(sysm.make_weights(cfg, args.seed, dev), 4),
                                           toks, 8, positions)
        low_want, _, low_gap = ref.logits_at(cfg, q8, toks, 8, positions, low_routes)

    def rel(a, w):
        return (torch.linalg.vector_norm(a - w, dim=-1) / torch.linalg.vector_norm(w, dim=-1)).amax(0).tolist()

    out["decode_check"] = {
        "positions": positions, "program_rel_l2": rel(got, want), "program_route_gap": gap,
        "program_rel_l2_own_routing": rel(got, own), "argmax_equal": (got.argmax(-1) == want.argmax(-1)).float().mean(0).tolist(),
        "int4_control_rel_l2": rel(low, low_want), "int4_control_route_gap": low_gap}
    out["peak_gb"] = gb()
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
