#!/usr/bin/env python3
"""The row-dot kernel of ``csrc/attention.cu`` (q·Kᵀ and the decode GEMV)
under other launch plans than ``attention.rowdot_plan`` gives, each read in
turns with the plan's own on one card: what the plan's choices of threads a
row, warps a block and grid are worth at the paths' shapes.

Run from the repository root on a machine with one CUDA card::

    python3 scripts/torch_rowdot_variants.py [--out FILE]

The shapes are the serving call's q·Kᵀ (``chip_smoke.DECODE_CAPACITY`` rows
of ``head_dim`` int8, one query), the decode layer's at 4096 rows, and the
decode GEMV at ``chip_smoke.GEMV_SHAPES`` and ``chip_smoke.GEMV_BENCH``
(int32), random operands from seed 4.  A variant sets the threads on a row
(``span``: lanes, and warps past 32), the warps of a block and, where
given, the grid (else one step of rows a block, balanced steps above
``attention.ROWDOT_MAX_BLOCKS``, as the plan does); the unroll follows from
the chunks a lane takes.  A variant
equal to the plan reads the spread of a pair.  Every variant's output must
be bit-equal to the plan's; each pair is read in ``chip_smoke.PAIRED_ROUNDS``
rounds (CUDA-graph replay), the variant first in every other round, warm
and with the operands cold in L2.  It prints one JSON object and exits 1 if
any output differs.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 4

# shape name → variants: (span, warps, blocks or None)
VARIANTS = {
    "qk_serving": [(1, 8, None), (2, 8, None), (4, 8, None), (8, 8, None), (1, 4, None), (2, 4, None)],
    "qk_layer_4096": [(1, 8, None), (2, 8, None), (4, 8, None), (4, 2, None), (2, 2, None)],
    "q_o_proj": [(8, 8, None), (16, 8, None), (32, 8, None), (64, 8, None), (64, 2, None), (128, 8, None),
                 (16, 2, None)],
    "k_v_proj": [(8, 8, None), (16, 8, None), (32, 8, None), (32, 1, None), (64, 8, None), (64, 2, None),
                 (128, 4, None)],
    "gate_up_proj": [(8, 8, None), (16, 8, None), (32, 8, None), (64, 8, None), (8, 4, None), (16, 4, None)],
    "down_proj": [(16, 8, None), (32, 8, None), (64, 8, None), (128, 8, None), (256, 8, None), (128, 4, None)],
    "lm_head": [(16, 8, 528), (16, 8, 1056), (16, 8, 2374), (16, 8, None), (16, 8, 4748), (16, 8, 9496),
                (8, 8, None), (32, 8, None), (16, 4, None)],
    "kernels_bench_int32": [(16, 8, None), (32, 8, None), (64, 8, None), (128, 8, None), (256, 8, None),
                            (128, 4, None), (32, 4, None)],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_rowdot_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as att

    _build.build_all()
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(SEED)

    def ints(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=g, dtype=dtype).to(dev)

    t, d = cs.DECODE_CAPACITY, cs.DECODE_CFG["head_dim"]
    # name → (entry point, a (1, K), w (rows, K))
    shapes = {"qk_serving": ("attention_qk", ints((1, d), -128, 128, torch.int8), ints((t, d), -128, 128, torch.int8)),
              "qk_layer_4096": ("attention_qk", ints((1, d), -128, 128, torch.int8),
                                ints((4096, d), -128, 128, torch.int8))}
    for name, (m, k) in cs.GEMV_SHAPES.items():
        shapes[name] = ("decode_gemv", ints((1, k), -128, 128, torch.int8), ints((m, k), -128, 128, torch.int8))
    m, k = cs.GEMV_BENCH
    shapes["kernels_bench_int32"] = ("decode_gemv", ints((1, k), -50, 50, torch.int32), ints((m, k), -50, 50, torch.int32))

    def launcher(entry, plan):
        """``fn(a, w)``: one launch of ``entry`` under ``plan``, a new output a call."""
        def run(a, w):
            rows, kk = w.shape
            nb = w.element_size()
            out = torch.empty((rows,), dtype=torch.int32, device=dev)
            head = ((a.data_ptr(), w.data_ptr(), out.data_ptr(), 1, rows, kk) if entry == "attention_qk"
                    else (w.data_ptr(), a.data_ptr(), out.data_ptr(), rows, kk))
            _build.launch(entry, dev, *head, nb, nb, 1, plan.lanes, plan.split, plan.warps, plan.unroll, plan.group,
                          plan.blocks)
            return out
        return run

    def variant(rows, chunks, span, warps, blocks):
        split = max(1, span // 32)
        iters = -(-chunks // span)
        unroll = min(att.ROWDOT_UNROLL, 1 << max(0, iters - 1).bit_length())
        steps = -(-rows // (32 * warps // span))
        return att.RowdotPlan(True, min(span, 32), split, warps, unroll, 1,
                              blocks or -(-steps // -(-steps // att.ROWDOT_MAX_BLOCKS)))

    def paired(pair):
        sums, _ = cs.paired_rounds([pair], cs.PAIRED_ROUNDS)
        return {"variant_ms": cs.median(sorted(sums["kernel"])), "plan_ms": cs.median(sorted(sums["library"])),
                "variant_faster_rounds": sum(v < p for v, p in zip(sums["kernel"], sums["library"])), "rounds": sums}

    result = {"gpu": cs.nvidia_smi("name,power.limit"), "torch": torch.__version__, "cuda": torch.version.cuda,
              "rounds": cs.PAIRED_ROUNDS, "shapes": {}}
    ok = True
    for name, (entry, a, w) in shapes.items():
        rows, kk = w.shape
        plan = att.rowdot_plan(rows, kk, 1, w.element_size(), a.element_size(), (w.data_ptr(), a.data_ptr()))
        base = launcher(entry, plan)
        want = base(a, w).clone()
        row = {"rows": rows, "k": kk, "dtype": str(w.dtype), "plan": plan._asdict(), "variants": []}
        for span, warps, blocks in VARIANTS[name]:
            vp = variant(rows, kk * w.element_size() // 16, span, warps, blocks)
            run = launcher(entry, vp)
            same = torch.equal(run(a, w), want)
            ok &= same
            warm = paired((cs.graph_timer(torch, lambda: run(a, w)), cs.graph_timer(torch, lambda: base(a, w))))
            cold = paired((cs.cold_timer(torch, run, (a, w)), cs.cold_timer(torch, base, (a, w))))
            row["variants"].append({"plan": vp._asdict(), "bit_equal": same, "warm": warm, "cold": cold})
            print(f"{name} {tuple(w.shape)}: plan {tuple(plan)[1:]} vs variant {tuple(vp)[1:]}: warm "
                  f"{warm['plan_ms'] * 1e3:.3f} / {warm['variant_ms'] * 1e3:.3f} us (variant faster in "
                  f"{warm['variant_faster_rounds']}), cold {cold['plan_ms'] * 1e3:.3f} / {cold['variant_ms'] * 1e3:.3f}"
                  f" us ({cold['variant_faster_rounds']}); bit-equal {same}", file=sys.stderr)
        result["shapes"][name] = row
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
