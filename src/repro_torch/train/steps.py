"""The train step of the PyTorch port: the port of the JAX package's
``train/steps.py`` on one device.

``make_train_step`` builds the update: the loss and its gradients by
autograd (``models/transformer.loss_fn``, each block rematerialized under
``RunFlags.remat``), ``grad_accum`` microbatches summed in float32, then
AdamW under the config's schedule.  The step consumes the state it is given
(the moments and master weights are updated in place, as JAX's trainer
donates its train state) and returns the new one.

Sharding waits for ROADMAP S13 (``dist/sharding.py``): ``zero1_spec``,
``train_state_specs``, ``batch_specs_tree`` and ``jit_train_step`` have no
counterpart yet, and ``make_train_step(..., rules=...)`` raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.runtime import DEFAULT_FLAGS, RunFlags
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update, schedule_for, tree_map


def make_train_state(params: Any, opt_cfg: AdamWConfig) -> Dict[str, Any]:
    some = next(iter(transformer._tree_leaves(params)))
    return {"params": params, "opt": adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


def train_state_shape(cfg: ModelConfig, opt_cfg: AdamWConfig) -> Dict[str, Any]:
    """The train state on the ``meta`` device: shapes and dtypes, no
    storage (JAX's ``jax.eval_shape`` of :func:`make_train_state`)."""
    return make_train_state(transformer.init_params(cfg, device="meta"), opt_cfg)


def train_state_from_numpy(tree: Any, device: Any = "cuda") -> Dict[str, Any]:
    """The port's train state from a nested dict of arrays with the JAX
    package's keys and dtypes (``jax.tree_util.tree_map(np.asarray, ...)``
    of its ``make_train_state`` or a restored checkpoint): ``params``,
    ``opt`` (``m``, ``v``, ``master`` and ``count``) and ``step``, each leaf
    on ``device`` with the same dtype and bits."""
    return transformer.params_from_numpy(tree, device=device)


def _grads_of(params: Any, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
              flags: RunFlags) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, gradients) of ``loss_fn`` at ``params``: JAX's
    ``value_and_grad(..., has_aux=True)``.  A leaf the loss does not reach
    gets a zero gradient, as in JAX."""
    leaves = transformer._tree_leaves(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    it = iter(live)
    p = transformer._tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = transformer.loss_fn(p, cfg, batch, flags)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(leaf) for g, leaf in zip(grads, leaves))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, transformer._tree_map(lambda _: next(it), params)


def make_train_step(
    cfg: ModelConfig,
    flags: RunFlags = DEFAULT_FLAGS,
    rules: Any = None,
    opt_cfg: AdamWConfig = AdamWConfig(),
    base_lr: float = 3e-4,
    total_steps: int = 10_000,
) -> Callable[[Dict[str, Any], Dict[str, torch.Tensor]], Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (new_state, metrics)`` with metrics
    ``loss``, ``lr``, ``ce`` and ``aux``.  Sharding ``rules`` raise
    (ROADMAP S13)."""
    transformer.check_supported(cfg, rules)
    sched = schedule_for(cfg, base_lr, total_steps)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        k = flags.grad_accum
        if k > 1:
            # microbatch over the leading batch dim; fp32 grad accumulator
            grads = tree_map(lambda l: torch.zeros(l.shape, dtype=torch.float32, device=l.device), state["params"])
            loss = torch.zeros((), dtype=torch.float32, device=state["step"].device)
            for i in range(k):
                mb = {n: a.reshape((k, a.shape[0] // k) + tuple(a.shape[1:]))[i] for n, a in batch.items()}
                mb_loss, metrics, g = _grads_of(state["params"], cfg, mb, flags)
                grads = tree_map(lambda acc, gg: acc + gg.to(torch.float32) / k, grads, g)
                loss = loss + mb_loss / k
                del g
        else:
            loss, metrics, grads = _grads_of(state["params"], cfg, batch, flags)
        lr = sched(state["step"])
        new_params, new_opt = adamw_update(grads, state["opt"], state["params"], opt_cfg, lr)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "lr": lr, **metrics}

    return train_step
