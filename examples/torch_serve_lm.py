"""Batched serving with the PIMSAB adaptive-precision stack on the PyTorch
port: int8 bit-sliced weights (and, with ``--quant-kv``, an int8 KV cache
scored on the row-dot kernel) over mixed-architecture backbones.  The
port's counterpart of ``examples/serve_lm.py``, on the card by default:

    PYTHONPATH=src python examples/torch_serve_lm.py                # on the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import api
from repro_torch.models.runtime import RunFlags
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quant-kv", action="store_true", help="int8 KV cache")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    for arch in ("qwen2-0.5b", "recurrentgemma-2b", "xlstm-1.3b"):
        cfg = reduced_config(get_config(arch))
        flags = RunFlags(attn_chunk=32, flash_threshold=128, quant_serve=True, quant_kv=args.quant_kv)
        params = init_params(cfg, 0, device=args.device)
        engine = ServeEngine(cfg, params, flags, max_len=64)
        reqs = [
            Request(rid=i, prompt=rng.integers(2, 200, 6).astype(np.int32), max_new_tokens=6)
            for i in range(4)
        ]
        api.reset_launch_counts()
        t0 = time.time()
        done = engine.run(reqs)
        toks = sum(len(r.generated) for r in done)
        print(f"{arch:22s} {toks} tokens in {time.time()-t0:5.2f}s (int8 weights; kernel launches "
              f"{api.launch_counts() or 'none: the plain versions on the CPU'})")


if __name__ == "__main__":
    main()
