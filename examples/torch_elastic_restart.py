"""Fault-tolerance drill of the PyTorch port: train, 'lose' nodes mid-run,
restart from the latest checkpoint, and verify the loss trajectory continues
(the data pipeline replays deterministically from the cursor).  The port's
counterpart of ``examples/elastic_restart.py``, on the card by default:

    PYTHONPATH=src python examples/torch_elastic_restart.py                # on the card
    PYTHONPATH=src python examples/torch_elastic_restart.py --device cpu
"""
import argparse
import tempfile

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.runtime import RunFlags
from repro_torch.train.fault import HeartbeatMonitor, RestartPolicy
from repro_torch.train.trainer import TrainLoopConfig, train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = reduced_config(get_config("minicpm-2b"))
    flags = RunFlags(attn_chunk=32, flash_threshold=128)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)

    with tempfile.TemporaryDirectory() as ckpt:
        # phase 1: run to step 60, checkpointing every 30
        loop = TrainLoopConfig(steps=60, ckpt_every=30, ckpt_dir=ckpt, log_every=20, schedule_steps=120)
        out1 = train(cfg, data_cfg, loop, flags, device=args.device)
        print("phase 1:", out1["history"])

        # failure: the monitor flags dead workers; the policy picks a new mesh
        mon = HeartbeatMonitor(n_workers=512)
        plan = RestartPolicy().on_failure(mon, dead=[17, 403])
        print(f"failure plan: {plan}")

        # phase 2: restart from the latest checkpoint (the data cursor
        # resumes exactly; one device here, so the state is not re-sharded)
        loop2 = TrainLoopConfig(steps=120, ckpt_every=60, ckpt_dir=ckpt, log_every=20, schedule_steps=120)
        out2 = train(cfg, data_cfg, loop2, flags, device=args.device)
        print(f"phase 2 (resumed from {out2['resumed_from']}):", out2["history"])
        assert out2["resumed_from"] == 60
        assert out2["history"][-1]["loss"] < out1["history"][0]["loss"]
        print("elastic restart drill: OK")


if __name__ == "__main__":
    main()
