#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--fault altered-token] [--out path.json]

For each seed: the cell's set-up, the ``check_batches`` a run checks and
four more of its traffic through the program (untimed),
the program's state freed, then the cell's check on what they produced.
For each control seed the same check, with the reference computed in the
next precision down standing in for the program (the control).  With
``--fault`` the program runs with that fault planted where its answer is
produced (``altered-token``: the prefill step's logits promote, in one
request a batch, a token far below the best, which is then served), and
its check is read as a sound run's.  The
readings go to standard output, one JSON line a reading, and with
``--out`` to a JSON file.  Not run by the benchmark's own runs.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def promote_other_token(logits):
    """Row 0 answers with the worst of the first 256 tokens."""
    logits = logits.clone()
    worst = logits[0, :256].argmin()
    logits[0, worst] = logits[0].max() + 1
    return logits


def plant_altered_token():
    """Plant the fault in the LM head; returns what undoes it."""
    from repro_torch.models import transformer

    plain = transformer._lm_head

    def head(params, x, cfg, ms=None):
        logits = plain(params, x, cfg, ms)
        return promote_other_token(logits[:, 0])[:, None] if logits.dim() == 3 else promote_other_token(logits)

    transformer._lm_head = head
    return lambda: setattr(transformer, "_lm_head", plain)


FAULTS = {"altered-token": plant_altered_token}


def readings(cell_name: str, seeds, control_seeds, device, log=print, fault=None):
    """One record a (seed, side): the cell's checks and the seconds taken."""
    from perfbench.bench import spec
    from perfbench.bench.trace import Spans

    bench = spec.load_benchmark(ROOT)
    cell = spec.by_name(bench["workloads"], cell_name, "workload")
    config, traffic = spec.config_of(bench, cell, ROOT), spec.traffic_of(cell, ROOT)
    limits = spec.limits_of(cell_name, ROOT)
    n = traffic["check_batches"] + 4
    out = []
    undo = FAULTS[fault]() if fault else None
    for seed in sorted(set(seeds) | set(control_seeds)):
        t = time.perf_counter()
        system = spec.system(config["system"]).System(config, traffic, seed, device, Spans(False))
        system.setup()
        for i in range(n):
            system.observe(i, system.call(i))
        system.release()
        sides = ([False] if seed in seeds else []) + ([True] if seed in control_seeds else [])
        for control in sides:
            c0 = time.perf_counter()
            rec = {"workload": cell_name, "seed": seed, "control": control, "fault": fault, "batches": n,
                   "checks": system.check(limits, control=control),
                   "check_s": time.perf_counter() - c0, "seed_s": time.perf_counter() - t}
            log(json.dumps(rec))
            out.append(rec)
        del system
    if undo:
        undo()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + sys.path[1:]
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    recs = readings(args.workload, seeds, control, torch.device("cuda:0"),
                    log=lambda s: print(s, flush=True), fault=args.fault)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
