"""The training loop of the PyTorch port: data pipeline + train step +
checkpoint/restart + heartbeat, wired together as in the JAX package's
``train/trainer.py``.  Runs on the card by default (``device="cuda"``), or on
the CPU when asked (the tests, at ``reduced_config``).  Under sharding
``rules`` every rank of the process group runs this loop (SPMD): it draws
the same global batch, the step keeps its rows, a rank holds its slices of
the state on the model axis (and its ZeRO-1 shards), and rank 0 alone
writes the checkpoints, in the global layout gathered over both axes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import api
from repro_torch.models.runtime import DEFAULT_FLAGS, RunFlags
from repro_torch.models.transformer import init_params
from repro_torch.train import checkpoint
from repro_torch.train.fault import HeartbeatMonitor
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.steps import (
    gather_train_state,
    init_train_state,
    make_train_step,
    shard_train_state,
    train_state_shape,
    train_state_specs,
)


@dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    base_lr: float = 3e-4
    seed: int = 0
    # LR schedule horizon; fixed independently of `steps` so an interrupted
    # run resumed with a different --steps sees identical per-step LRs
    schedule_steps: Optional[int] = None


def train(
    cfg: ModelConfig,
    data_cfg: DataConfig,
    loop: TrainLoopConfig,
    flags: RunFlags = DEFAULT_FLAGS,
    rules: Any = None,
    resume: bool = True,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """Train; returns {'state', 'history', 'resumed_from'}.  Parameters
    are ``init_params(cfg, loop.seed)`` on ``device`` (the port's draws, not
    JAX's), or the latest checkpoint in ``loop.ckpt_dir``, with the data
    cursor it saved.  Under ``rules`` (a ``MeshRules`` over the process
    group) this is one rank's loop; its returned state is its own (its
    model-axis slices, and ZeRO-1 shards under ``flags.zero1``:
    ``steps.gather_train_state`` gives the global one).  A checkpoint
    restores at any (dp, tp)."""
    dev = api.resolve_device(device)
    opt_cfg = AdamWConfig(lr=loop.base_lr)
    step_fn = make_train_step(
        cfg, flags, rules, opt_cfg,
        base_lr=loop.base_lr, total_steps=loop.schedule_steps or loop.steps,
    )
    specs = train_state_specs(cfg, rules, opt_cfg, flags) if rules is not None else None
    spmd = rules is not None and dist.is_initialized()

    start_step, extra = 0, {}
    if resume and loop.ckpt_dir and checkpoint.latest_step(loop.ckpt_dir) is not None:
        state, start_step, extra = checkpoint.restore(loop.ckpt_dir, train_state_shape(cfg, opt_cfg), device=dev)
        resumed = start_step
        if specs is not None:
            state = shard_train_state(state, specs, rules)
    else:
        state = init_train_state(init_params(cfg, loop.seed, device=dev), cfg, opt_cfg, specs, rules)
        resumed = None

    pipe = TokenPipeline(data_cfg, start_step=extra.get("data_step", start_step))
    monitor = HeartbeatMonitor(n_workers=1)
    history = []
    t_last = time.time()
    try:
        for i in range(start_step, loop.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
            state, metrics = step_fn(state, batch)
            monitor.beat(0, i)
            if (i + 1) % loop.log_every == 0 or i == loop.steps - 1:
                loss = float(metrics["loss"])  # waits for the step on the card
                dt = (time.time() - t_last) / loop.log_every
                t_last = time.time()
                history.append({"step": i + 1, "loss": loss, "s_per_step": dt})
            if loop.ckpt_dir and ((i + 1) % loop.ckpt_every == 0 or i == loop.steps - 1):
                whole = gather_train_state(state, specs, rules) if specs is not None else state
                if not spmd or dist.get_rank() == 0:
                    checkpoint.save(loop.ckpt_dir, whole, i + 1, extra={"data_step": pipe.state()})
                    checkpoint.prune(loop.ckpt_dir)
                del whole
                if spmd:
                    dist.barrier()
    finally:
        pipe.close()
    return {"state": state, "history": history, "resumed_from": resumed}
