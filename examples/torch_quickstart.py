"""Quickstart of the PyTorch port: train a tiny LM for a few hundred steps,
checkpoint, resume, then serve it with int8 bit-sliced weights (the
bit-sliced GEMM kernel on the card, its plain version on the CPU).  The
port's counterpart of ``examples/quickstart.py``, on the card by default:

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.runtime import RunFlags
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.trainer import TrainLoopConfig, train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()

    cfg = reduced_config(get_config("qwen2-0.5b"))
    flags = RunFlags(attn_chunk=32, flash_threshold=128)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)

    with tempfile.TemporaryDirectory() as ckpt:
        half = args.steps // 2
        loop = TrainLoopConfig(steps=half, ckpt_every=half, ckpt_dir=ckpt, log_every=25, schedule_steps=args.steps)
        first_run = train(cfg, data_cfg, loop, flags, device=args.device)
        # resume from the checkpoint at the half-way step and run to the end
        loop = TrainLoopConfig(steps=args.steps, ckpt_every=half, ckpt_dir=ckpt, log_every=25,
                               schedule_steps=args.steps)
        out = train(cfg, data_cfg, loop, flags, device=args.device)
        print(f"resumed from {out['resumed_from']}")
        print("loss curve:")
        for h in first_run["history"] + out["history"]:
            print(f"  step {h['step']:4d}  loss {h['loss']:.3f}  ({h['s_per_step']*1e3:.0f} ms/step)")
        first, last = first_run["history"][0]["loss"], out["history"][-1]["loss"]
        assert last < first, "loss should decrease"

        # serve the trained weights (int8 bit-sliced — the PIMSAB path)
        engine = ServeEngine(cfg, out["state"]["params"], flags, max_len=96)
        rng = np.random.default_rng(0)
        reqs = [
            Request(rid=i, prompt=rng.integers(2, 200, 8).astype(np.int32), max_new_tokens=8)
            for i in range(4)
        ]
        for r in engine.run(reqs):
            print(f"request {r.rid}: generated {r.generated}")
    print("quickstart: OK")


if __name__ == "__main__":
    main()
