#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this machine holds.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It measures ``repro_torch`` (``src/``) only,
prints what it did on standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the correctness check compared, with its limit.
The same numbers close standard error.

It exits non-zero and prints no result without enough CUDA devices, and
when ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` has been
imported (whole top-level names: the port is ``repro_torch``).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]

    import torch

    from perfbench.bench import harness, spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.by_name(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(f"perfbench: {msg}", file=sys.stderr, flush=True)

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                              t0=T0, root=ROOT, bench=bench, log=log)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run imported {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}, {c['compared']} compared)", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
