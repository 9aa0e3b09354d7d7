#!/usr/bin/env python3
"""The decode step's q·Kᵀ (K6), KV append (K10), softmax (K7) and p·V (K8)
kernels, the decode GEMV (K9) and the RG-LRU scan (K11) of two source trees,
read in turns on one card, so that a change is timed against its parent.

Run from the repository root on a machine with one CUDA card::

    mkdir -p build/parent && git archive HEAD src | tar -x -C build/parent
    python3 scripts/torch_attention_parent.py --parent build/parent/src [--src src] [--out FILE]

``--parent`` and ``--src`` are ``src`` directories whose ``repro_torch`` is
imported (the parent's first, then the change's, each keeping its own module
objects); each tree builds its kernels into its own ``build/``.  The inputs
are the serving path's T = 32768 call at Qwen2-0.5B's attention width
(``chip_smoke.DECODE_CFG``: head_dim 64, int8 caches, scores at in_frac 13,
an int8 one-hot selector on the last row), one query, random caches from
seed 4, the decode GEMV at ``chip_smoke.GEMV_SHAPES`` (Qwen2-0.5B's int8
projections and LM head) and ``chip_smoke.GEMV_BENCH`` in int32, and the
RG-LRU scan at ``chip_smoke.RGLRU_SHAPE`` (RecurrentGemma-2B's width, a =
sigmoid(normal), b and h0 normal).  The script checks that both trees'
outputs are bit-equal to the plain versions, then reads, in
``chip_smoke.PAIRED_ROUNDS`` rounds of both trees in turns (the parent first
in every other round), the median device time of:

* each kernel in CUDA-graph replay, warm and with its inputs cold in L2
  (rotated over copies worth more than ``chip_smoke.COLD_BYTES``);
* the kernel sequence of one decode step (``kv_append`` ×2, q·Kᵀ, softmax,
  p·V, ``kv_append`` ×2 for the carry), warm;

and, once each, the eager time of each kernel and the launch floor
(``chip_smoke.launch_floor``).  It prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 4


def load_tree(src: str):
    """``repro_torch.kernels.attention`` and ``rglru_scan`` of the tree at
    ``src``, its kernels built; the tree's modules leave ``sys.modules``
    again, so that another tree can be imported beside it."""
    def drop():
        for name in [n for n in sys.modules if n == "repro_torch" or n.startswith("repro_torch.")]:
            del sys.modules[name]

    drop()
    sys.path.insert(0, str(Path(src).resolve()))
    try:
        from repro_torch.kernels import _build, attention, rglru_scan

        _build.build_all()
    finally:
        sys.path.pop(0)
        drop()
    return attention, rglru_scan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the parent's src directory")
    ap.add_argument("--src", default=str(ROOT / "src"), help="the change's src directory")
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_attention_parent: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # its timers and decode configuration

    loaded = {"parent": load_tree(args.parent), "change": load_tree(args.src)}
    trees = {name: att for name, (att, _) in loaded.items()}
    scans = {name: rg for name, (_, rg) in loaded.items()}
    dev = torch.device("cuda", 0)
    ref = trees["change"].ref
    sigma = ref.softmax_sigma(cs.DECODE_CFG["score_frac"])
    shift = ref.SOFTMAX_F
    t, d = cs.DECODE_CAPACITY, cs.DECODE_CFG["head_dim"]
    g = torch.Generator().manual_seed(SEED)

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8).to(dev)

    kc, vc, q, k_new, v_new = i8((t, d)), i8((t, d)), i8((1, d)), i8((d,)), i8((d,))
    onehot = torch.zeros(t, dtype=torch.int8, device=dev)
    onehot[t - 1] = 1
    scores = trees["change"]._qk(q, kc)
    probs = trees["change"]._softmax_plain(scores.cpu(), sigma).to(dev)
    out = {"gpu": cs.nvidia_smi("name,power.limit"), "torch": torch.__version__, "cuda": torch.version.cuda,
           "parent": str(args.parent), "src": str(args.src), "shapes": {"scores": list(scores.shape),
                                                                          "v": list(vc.shape)}}
    want_sm, want_pv = probs.cpu(), trees["change"]._pv_plain(probs.cpu(), vc.cpu(), shift)
    gs = torch.Generator().manual_seed(SEED + 1)
    bsz, _, w = cs.RGLRU_SHAPE
    ga = torch.sigmoid(torch.randn(cs.RGLRU_SHAPE, generator=gs)).to(dev)
    gb, gh = torch.randn(cs.RGLRU_SHAPE, generator=gs).to(dev), torch.randn((bsz, w), generator=gs).to(dev)
    want_kv = trees["change"]._kv_append_plain(kc.cpu(), k_new.cpu(), onehot.cpu())
    want_scan = scans["change"]._scan(ga[:1].cpu(), gb[:1].cpu(), gh[:1].cpu())  # batch row 0, plain on the CPU
    want_qk = trees["change"]._qk_plain(q.cpu(), kc.cpu())
    gg = torch.Generator().manual_seed(SEED + 2)
    gemvs = {name: (torch.randint(-128, 128, (m, k), generator=gg, dtype=torch.int8).to(dev),
                    torch.randint(-128, 128, (k,), generator=gg, dtype=torch.int8).to(dev))
             for name, (m, k) in cs.GEMV_SHAPES.items()}
    m, k = cs.GEMV_BENCH
    gemvs["kernels_bench_int32"] = (torch.randint(-50, 50, (m, k), generator=gg, dtype=torch.int32).to(dev),
                                    torch.randint(-50, 50, (k,), generator=gg, dtype=torch.int32).to(dev))
    want_gemv = {name: trees["change"]._gemv_plain(w.cpu(), x.cpu()) for name, (w, x) in gemvs.items()}
    out["bit_equal"] = {name: {"qk": torch.equal(a._qk(q, kc).cpu(), want_qk),
                               "softmax": torch.equal(a._softmax(scores, sigma).cpu(), want_sm),
                               "pv": torch.equal(a._pv(probs, vc, shift).cpu(), want_pv),
                               "kv_append": torch.equal(a._kv_append(kc, k_new, onehot).cpu(), want_kv),
                               "rglru_scan": torch.equal(scans[name]._scan(ga, gb, gh)[:1].cpu(), want_scan),
                               **{f"decode_gemv[{g}]": torch.equal(a._gemv(w, x).cpu(), want_gemv[g])
                                  for g, (w, x) in gemvs.items()}}
                        for name, a in trees.items()}

    def paired(pair):
        """Medians and rounds of the change's and the parent's timers read in turns."""
        sums, _ = cs.paired_rounds([pair], cs.PAIRED_ROUNDS)
        return {"change_ms": cs.median(sorted(sums["kernel"])), "parent_ms": cs.median(sorted(sums["library"])),
                "change_rounds": sums["kernel"], "parent_rounds": sums["library"],
                "change_faster_rounds": sum(c < p for c, p in zip(sums["kernel"], sums["library"]))}

    kernels = {
        "attention_qk": (lambda n: trees[n]._qk, (q, kc)),
        **{f"decode_gemv[{g}]": (lambda n: trees[n]._gemv, wx) for g, wx in gemvs.items()},
        "kv_append": (lambda n: trees[n]._kv_append, (kc, k_new, onehot)),
        "softmax_fixedpoint": (lambda n: (lambda x: trees[n]._softmax(x, sigma)), (scores,)),
        "attention_pv": (lambda n: (lambda p, v: trees[n]._pv(p, v, shift)), (probs, vc)),
        "rglru_scan": (lambda n: scans[n]._scan, (ga, gb, gh)),
    }
    for kernel, (make, kargs) in kernels.items():
        fns = {name: make(name) for name in trees}
        row = {"warm": paired(tuple(cs.graph_timer(torch, lambda fn=fns[n]: fn(*kargs)) for n in ("change", "parent"))),
               "cold": paired(tuple(cs.cold_timer(torch, fns[n], kargs) for n in ("change", "parent")))}
        row["eager"] = {n: cs.cuda_ms(torch, lambda fn=fns[n]: fn(*kargs)) for n in ("change", "parent")}
        out[kernel] = row

    def step(a):
        def run():
            k2, v2 = a._kv_append(kc, k_new, onehot), a._kv_append(vc, v_new, onehot)
            ctx = a._pv(a._softmax(a._qk(q, k2), sigma), v2, shift)
            a._kv_append(kc, k_new, onehot)
            a._kv_append(vc, v_new, onehot)
            return ctx
        return run

    sums, _ = cs.paired_rounds([(cs.graph_timer(torch, step(trees["change"])),
                                 cs.graph_timer(torch, step(trees["parent"])))], cs.PAIRED_ROUNDS)
    out["decode_step_kernels"] = {"change_ms": cs.median(sorted(sums["kernel"])),
                                  "parent_ms": cs.median(sorted(sums["library"])), "rounds": sums}
    out["launch_floor_ms"] = cs.launch_floor(torch, dev)
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    ok = all(all(v.values()) for v in out["bit_equal"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
