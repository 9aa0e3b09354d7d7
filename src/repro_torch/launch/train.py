"""Training launcher CLI of the PyTorch port: the JAX package's
``launch/train.py`` with its flags, plus ``--device``.

    python -m repro_torch.launch.train --arch recurrentgemma-2b            # on the card
    python -m repro_torch.launch.train --arch qwen2-0.5b --reduced --steps 4 --device cpu

``--device`` defaults to ``cuda``, as every entry point of the port; without
a card the CLI raises unless ``--device cpu`` is given.  The run flags are
the JAX launcher's (``attn_chunk`` 64, ``flash_threshold`` 256, remat on).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import api
from repro_torch.models.runtime import RunFlags
from repro_torch.train.trainer import TrainLoopConfig, train

TRAIN_FLAGS = RunFlags(attn_chunk=64, flash_threshold=256)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = api.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    loop = TrainLoopConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, base_lr=args.lr
    )
    out = train(cfg, data_cfg, loop, TRAIN_FLAGS, resume=not args.no_resume, device=dev)
    for h in out["history"]:
        print(h)
    if out["resumed_from"] is not None:
        print(f"(resumed from step {out['resumed_from']})")


if __name__ == "__main__":
    main()
