"""Serving launcher CLI of the PyTorch port: random-inits a model, runs the
batched engine over synthetic requests with int8 bit-sliced weights, and
prints what the JAX package's ``launch/serve.py`` prints.

    python -m repro_torch.launch.serve --arch qwen2-0.5b            # on the card
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --reduced --device cpu

Every arch of ``repro_torch.configs.list_archs()`` serves; an
encoder–decoder one (whisper-medium) gets zero frame embeddings.

``--device`` defaults to ``cuda``, as every entry point of the port; without
a card the CLI raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import api
from repro_torch.models.runtime import RunFlags
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine

PROMPT_LEN = 8
MAX_LEN = 128


def serve_flags(quant: bool = True, cfg=None) -> RunFlags:
    """The launcher's run flags: the JAX launcher's (``attn_chunk`` 64,
    ``flash_threshold`` 256), except that an encoder–decoder ``cfg`` raises
    the threshold to its ``enc_seq_len`` so that the encoder's frames take
    the direct attention.  At 256, whisper-medium's 1500 frames would take
    the chunked attention, which needs a multiple of the chunk: the JAX
    launcher fails there (an assertion), the port's would raise.  At
    ``reduced_config`` (8 frames) the flags are the JAX launcher's."""
    threshold = max(256, cfg.enc_seq_len) if cfg is not None and cfg.is_encdec else 256
    return RunFlags(attn_chunk=64, flash_threshold=threshold, quant_serve=quant)


def make_requests(cfg, n: int, new_tokens: int, seed: int = 0, prompt_len: int = PROMPT_LEN) -> List[Request]:
    """``n`` requests of ``prompt_len`` random tokens in [2, vocab) drawn from
    ``np.random.default_rng(seed)``, as the JAX launcher draws them."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, size=prompt_len).astype(np.int32),
                    max_new_tokens=new_tokens) for i in range(n)]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = api.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    flags = serve_flags(quant=not args.no_quant, cfg=cfg)
    params = init_params(cfg, 0, device=dev)
    engine = ServeEngine(cfg, params, flags, max_len=MAX_LEN)
    reqs = make_requests(cfg, args.requests, args.new_tokens)
    t0 = time.time()
    done = engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s, quant_serve={flags.quant_serve})")
    for r in done[:2]:
        print(f"  req {r.rid}: {r.generated[:8]}...")


if __name__ == "__main__":
    main()
