#!/usr/bin/env python3
"""Where the card's logits leave those of a CPU copy, for the model families
of ``chip_smoke.py`` phase 3l: every intermediate output of a prefill and of
one decode step (each attention, cross-attention and FFN output, each
recurrent block's output and new state, the causal convolution, the RG-LRU
coefficients, the mLSTM chunk scan and decode step, the per-head norm) is
recorded on the card and on a CPU copy of the same int8-served weights, in
call order, and the first that differs is printed with its size.

Run from the repository root on a machine with one CUDA card::

    python3 scripts/torch_family_gap_probe.py [--out FILE]

Configs at full width, cut to their first pattern groups as phase 3l's
card-against-CPU check cuts them: xLSTM-1.3B (8 layers), Whisper-medium (2
decoder and 2 encoder layers, 1500 frames), RecurrentGemma-2B (13 layers);
random bfloat16 weights from seed 0 drawn for the cut config (not phase
3l's), 4 prompts of 8 tokens from seed 2, frame embeddings from seed 3.  Each
decode step is fed its own device's greedy tokens, so its records are
comparable only when ``tokens_equal``.  Prints one line a family and exits 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = (("xlstm-1.3b", 1, 0), ("whisper-medium", 2, 2), ("recurrentgemma-2b", 1, 0))  # groups, encoder layers
RECORDED = {"transformer": ("_attn_apply", "_ffn_apply", "_attn_decode", "_cross_decode", "_cross_apply", "_cross_kv"),
            "recurrent": ("causal_conv1d", "_mlstm_chunk_scan", "_mlstm_decode_step", "_groupnorm_heads",
                          "_rglru_coeffs")}
MIXERS = ("rglru", "mlstm", "slstm")


def _tensors(o, prefix):
    if isinstance(o, dict):
        for n, v in sorted(o.items()):
            yield from _tensors(v, f"{prefix}.{n}")
    elif isinstance(o, (tuple, list)):
        for i, v in enumerate(o):
            yield from _tensors(v, f"{prefix}[{i}]")
    elif hasattr(o, "detach"):
        yield prefix, o


def _record(mod, name, log):
    f = getattr(mod, name)

    def recorded(*args, **kwargs):
        out = f(*args, **kwargs)
        log.extend((n, t.detach().float().cpu()) for n, t in _tensors(out, name))
        return out

    setattr(mod, name, recorded)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the per-record differences to this JSON file")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("torch_family_gap_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import common, recurrent, transformer

    log = []
    for name in RECORDED["transformer"]:
        _record(transformer, name, log)
    for name in RECORDED["recurrent"]:
        _record(recurrent, name, log)
    for kind in MIXERS:  # the block applies, seen by transformer under its own names
        _record(recurrent, f"{kind}_block_apply", log)
        setattr(transformer, f"{kind}_block_apply", getattr(recurrent, f"{kind}_block_apply"))
        transformer._MIXER_APPLY[kind] = getattr(recurrent, f"{kind}_block_apply")
    dev = torch.device("cuda", 0)

    def run(cfg, params, batch, flags):
        with torch.no_grad():
            log.clear()
            cache, logits = transformer.prefill(params, cfg, batch, flags, max_len=16)
            pre = list(log)
            log.clear()
            tok = torch.argmax(logits.float().cpu(), -1).to(torch.int32)[:, None]
            _, logits2 = transformer.decode_step(params, cfg, cache, tok.to(logits.device), flags)
            dec = list(log)
        return pre, dec, logits.float().cpu(), logits2.float().cpu(), tok

    out = {"gpu": torch.cuda.get_device_name(0)}
    for arch, groups, enc in FAMILIES:
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, n_layers=groups * len(cfg.block_pattern),
                                  **({"n_enc_layers": enc} if enc else {}))
        flags = serve_cli.serve_flags(cfg=cfg)
        raw = transformer.init_params(cfg, 0, device=dev)
        on_card = common.maybe_quantize_tree(raw, cfg)
        on_cpu = common.maybe_quantize_tree(transformer._tree_map(lambda a: a.cpu(), raw), cfg)
        batch = {"tokens": torch.randint(2, cfg.vocab_size, (4, 8), generator=torch.Generator().manual_seed(2),
                                         dtype=torch.int32)}
        if cfg.is_encdec:
            batch["enc_embeds"] = torch.randn((4, cfg.enc_seq_len, cfg.d_model),
                                              generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
        pre_d, dec_d, l1d, l2d, tok_d = run(cfg, on_card, {k: v.to(dev) for k, v in batch.items()}, flags)
        pre_c, dec_c, l1c, l2c, tok_c = run(cfg, on_cpu, batch, flags)
        rep = {"tokens_equal": bool(torch.equal(tok_d, tok_c)), "largest_logit": float(l1c.abs().max()),
               "logit_gap": [float((l1d - l1c).abs().max()), float((l2d - l2c).abs().max())]}
        for what, card, cpu in (("prefill", pre_d, pre_c), ("decode", dec_d, dec_c)):
            rows = [[i, n, list(a.shape), float((a - b).abs().max()), float(b.abs().max()), int((a != b).sum())]
                    for i, ((n, a), (_, b)) in enumerate(zip(card, cpu))]
            rep[what] = rows
            rep[f"{what}_first_differing"] = next((r for r in rows if r[3] != 0), None)
        print(arch, json.dumps({k: v for k, v in rep.items() if k not in ("prefill", "decode")}))
        out[arch] = rep
        del raw, on_card, on_cpu
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
