#!/usr/bin/env python3
"""The int8 decode scores of ``repro_torch.models.attention.int8_scores``
(``einsum("bhgd,bthd->bhgt")`` of an int8 query and the int8 KV cache) in
each of its forms, on one card: R batch rows a row-dot call, for R from 1
(one call a batch row) to B (one call a layer over the whole cache), and one
call a (batch row, KV head) over the strided cache view (a copy of the
view each).  A call over R rows computes R·Hkv times the products the
contraction needs; the measurement says where its saved launches stop
paying for them, which sets ``attention.INT8_SCORES_CALL_BYTES``.

Run from the repository root on a machine with one CUDA card::

    python3 scripts/torch_int8_scores_forms.py [--out FILE]

The head shapes are those of the decoder-only archs' configs (KV heads,
GQA group, head dim): Qwen2-0.5B (2, 7, 64), InternLM2-20B (8, 6, 128),
MiniCPM-2B (36, 1, 64); the batch B and the cache rows T span a serving
engine's.  Random int8 operands from seed 4.  Each form is read two ways:
``wall``, the host clock over LAYERS back-to-back calls from an idle card
to the end of their device work, a call's share (the eager decode step,
which is host-bound); ``device``, a CUDA-graph replay of GRAPH_REPS calls
(launch cost left out, what a captured step would see).  Forms whose call
would write more than MAX_CALL_BYTES are skipped.  Every form's scores
must equal the one-row form's; one small case is also held to the CPU.  It
prints one JSON object and exits 1 if any output differs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 4
HEADS = {"qwen2-0.5b": (2, 7, 64), "internlm2-20b": (8, 6, 128), "minicpm-2b": (36, 1, 64)}
BATCHES = (1, 4, 16, 64)
CACHE_ROWS = (128, 1024, 4096)
LAYERS = 8       # calls a wall sample, back to back (a decode step's layers)
SAMPLES = 7      # wall samples a form; the median is kept
GRAPH_REPS = 4   # calls a CUDA graph replays
MAX_CALL_BYTES = 4 << 30


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_int8_scores_forms: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, api
    from repro_torch.models import attention as att

    _build.build_all()
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(SEED)

    def per_pair(qq, kq):
        b, hkv, gg, _ = qq.shape
        with api.on_device():
            rows = [api.attention_qk(qq[i, h], kq[i, :, h]) for i in range(b) for h in range(hkv)]
        return torch.stack(rows).view(b, hkv, gg, kq.shape[1])

    def wall_us(fn):
        for _ in range(2):
            fn()
        out = []
        for _ in range(SAMPLES):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(LAYERS):
                fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e6 / LAYERS)
        return cs.median(sorted(out))

    ok = True
    # one small case against the CPU's plain version
    qq = torch.randint(-128, 128, (3, 2, 7, 64), generator=g, dtype=torch.int8)
    kq = torch.randint(-128, 128, (3, 50, 2, 64), generator=g, dtype=torch.int8)
    want = att.int8_scores(qq, kq)
    for rows in (1, 2, 3):
        ok &= torch.equal(att._int8_scores_rows(qq.to(dev), kq.to(dev), rows).cpu(), want)
    ok &= torch.equal(per_pair(qq.to(dev), kq.to(dev)).cpu(), want)

    result = {"gpu": cs.nvidia_smi("name,power.limit"), "torch": torch.__version__, "cuda": torch.version.cuda,
              "layers": LAYERS, "samples": SAMPLES, "graph_reps": GRAPH_REPS,
              "call_bytes_cap": att.INT8_SCORES_CALL_BYTES, "cpu_case_equal": ok, "cases": []}
    for arch, (hkv, gg, d) in HEADS.items():
        for t in CACHE_ROWS:
            for b in BATCHES:
                qq = torch.randint(-128, 128, (b, hkv, gg, d), generator=g, dtype=torch.int8).to(dev)
                kq = torch.randint(-128, 128, (b, t, hkv, d), generator=g, dtype=torch.int8).to(dev)
                ref = att._int8_scores_rows(qq, kq, 1)
                forms = {}
                rows_list = sorted({1 << i for i in range(b.bit_length()) if 1 << i <= b} | {b})
                for rows in rows_list:
                    call_bytes = rows * rows * hkv * hkv * gg * t * 4
                    if call_bytes > MAX_CALL_BYTES:
                        forms[f"rows={rows}"] = {"skipped": f"a call would write {call_bytes} bytes"}
                        continue
                    fn = lambda rows=rows: att._int8_scores_rows(qq, kq, rows)  # noqa: E731
                    same = torch.equal(fn(), ref)
                    ok &= same
                    forms[f"rows={rows}"] = {"rows": rows, "calls": -(-b // rows), "call_bytes": call_bytes,
                                             "products_factor": rows * hkv, "equal": same, "wall_us": wall_us(fn),
                                             "device_us": cs.graph_ms(torch, fn, GRAPH_REPS, 2) * 1e3}
                    torch.cuda.empty_cache()
                fn = lambda: per_pair(qq, kq)  # noqa: E731
                same = torch.equal(fn(), ref)
                ok &= same
                forms["per_pair"] = {"calls": b * hkv, "equal": same, "wall_us": wall_us(fn),
                                     "device_us": cs.graph_ms(torch, fn, GRAPH_REPS, 2) * 1e3}
                timed = {k: v for k, v in forms.items() if "wall_us" in v}
                best_wall = min(timed, key=lambda k: timed[k]["wall_us"])
                best_dev = min(timed, key=lambda k: timed[k]["device_us"])
                rule = att.int8_scores_rows_per_call(b, hkv, gg, t)
                case = {"arch": arch, "hkv": hkv, "g": gg, "d": d, "b": b, "t": t, "forms": forms,
                        "best_wall": best_wall, "best_device": best_dev, "rule_rows": rule}
                result["cases"].append(case)
                print(f"{arch} B={b} T={t}: " + ", ".join(
                    f"{k} {v['wall_us']:.1f}/{v['device_us']:.1f} us" for k, v in timed.items())
                    + f"; best wall {best_wall}, best device {best_dev}, rule rows={rule}", file=sys.stderr)
                del qq, kq, ref
                torch.cuda.empty_cache()
    result["ok"] = ok
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
