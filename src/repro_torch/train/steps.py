"""The train step of the PyTorch port and its sharding trees: the port of the
JAX package's ``train/steps.py``.

``make_train_step`` builds the update: the loss and its gradients by
autograd (``models/transformer.local_loss``, each block rematerialized under
``RunFlags.remat``), ``grad_accum`` microbatches summed in float32, then
AdamW under the config's schedule.  The step consumes the state it is given
(the moments and master weights are updated in place, as JAX's trainer
donates its train state) and returns the new one.

Under sharding ``rules`` (a ``MeshRules`` on a process mesh, ROADMAP S13
and S13b) the step is SPMD over the process group: each rank takes its rows
of the global batch (:func:`batch_specs_tree`), forms its share of JAX's
global loss (its summed token losses over the global token count), and the
gradients are summed over the data axes.  On a model axis wider than one a
rank holds its slices of the leaves ``param_specs`` shards, with their
moments and master weights: their gradients stay its slices', those of the
replicated leaves come out equal on every rank of the axis (the model's
conjugate collectives), and the clipping norm adds the slices' squares over
the axis.  Under ``RunFlags.zero1`` each rank keeps the moments and master
weights only for its :func:`zero1_spec` shard of each leaf, cut from its
model-axis slice, updates that shard and gathers the new parameters over
the data axes.  :func:`shard_train_state` cuts a global state to a rank's
(:func:`init_train_state` builds one without the global moments) and
:func:`gather_train_state` gives back the global layout.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives, sharding
from repro_torch.dist.sharding import MeshRules, P, gather_leaf, param_specs, shard_leaf, shard_params
from repro_torch.models import transformer
from repro_torch.models.runtime import DEFAULT_FLAGS, RunFlags
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    schedule_for,
    tree_leaves,
    tree_map,
)


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


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------


def zero1_spec(spec: P, shape, rules: MeshRules) -> P:
    """Additionally shard an optimizer-state leaf over the data axes (ZeRO-1).

    The first dimension not already sharded whose size divides dp gets the dp
    axes — the fp32 m/v/master tensors are the memory hog at scale.
    """
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, size) in enumerate(zip(parts, shape)):
        if ax is None and size % rules.dp == 0 and size >= rules.dp:
            parts[i] = rules.dp_axes
            return P(*parts)
    return spec


def train_state_specs(cfg: ModelConfig, rules: MeshRules, opt_cfg: AdamWConfig, flags: RunFlags):
    shapes = train_state_shape(cfg, opt_cfg)
    pspecs = param_specs(shapes["params"], cfg, rules)

    def opt_leaf_specs(subtree_shapes):
        base = param_specs(subtree_shapes, cfg, rules)
        if not flags.zero1:
            return base
        return tree_map(lambda sp, sh: zero1_spec(sp, sh.shape, rules), base, subtree_shapes)

    ospecs = {
        "m": opt_leaf_specs(shapes["opt"]["m"]),
        "v": opt_leaf_specs(shapes["opt"]["v"]),
        "count": P(),
    }
    if "master" in shapes["opt"]:
        ospecs["master"] = opt_leaf_specs(shapes["opt"]["master"])
    return {"params": pspecs, "opt": ospecs, "step": P()}


def batch_specs_tree(batch_shapes: Dict[str, Any], rules: MeshRules) -> Dict[str, Any]:
    out = {}
    for k, v in batch_shapes.items():
        axes = rules.batch_axes(v.shape[0])
        out[k] = P(axes, *([None] * (len(v.shape) - 1)))
    return out


def _dp_dim(spec: P, rules: MeshRules) -> Optional[int]:
    """The dim of ``spec`` sharded over the data axes, if any."""
    dp = P(rules.dp_axes)[0]
    return next((i for i, ax in enumerate(spec) if ax == dp), None)


def _local(x: torch.Tensor, spec: P, rules: MeshRules) -> torch.Tensor:
    """This rank's shard of the global ``x`` along its data-sharded dim (a
    copy; ``x`` itself on one data shard or a replicated leaf)."""
    d = _dp_dim(spec, rules)
    if d is None or rules.dp == 1:
        return x
    c = x.shape[d] // rules.dp
    return x.narrow(d, sharding.data_index(rules) * c, c).clone()


def _gather(x: torch.Tensor, spec: P, rules: MeshRules) -> torch.Tensor:
    """The global leaf of which every rank holds ``x``, its shard of
    ``spec``."""
    d = _dp_dim(spec, rules)
    if d is None:  # replicated: every rank holds the whole leaf
        return x
    return collectives.all_gather_dim(x, d, rules.dp, sharding.data_group(rules))


def _map_state(fn, state: Dict[str, Any], specs: Dict[str, Any]) -> Dict[str, Any]:
    """``fn(leaf, spec)`` over the parameters and optimizer leaves of a train
    state (``count`` and ``step`` as they are)."""
    opt = {k: (v if k == "count" else tree_map(fn, v, specs["opt"][k])) for k, v in state["opt"].items()}
    return {"params": tree_map(fn, state["params"], specs["params"]), "opt": opt, "step": state["step"]}


def shard_train_state(state: Dict[str, Any], specs: Dict[str, Any], rules: MeshRules) -> Dict[str, Any]:
    """This rank's train state from the global one: each parameter and
    optimizer leaf cut to its slice of ``specs`` (:func:`train_state_specs`)
    on the model axis and, under ZeRO-1, the data axes; a leaf the specs do
    not shard stays as it is."""
    return _map_state(lambda x, sp: shard_leaf(x, sp, rules), state, specs)


def gather_train_state(state: Dict[str, Any], specs: Dict[str, Any], rules: MeshRules) -> Dict[str, Any]:
    """The global train state from every rank's :func:`shard_train_state`
    (the layout checkpoints keep)."""
    return _map_state(lambda x, sp: gather_leaf(x, sp, rules), state, specs)


def init_train_state(params: Any, cfg: ModelConfig, opt_cfg: AdamWConfig, specs: Optional[Dict[str, Any]],
                     rules: Optional[MeshRules]) -> Dict[str, Any]:
    """:func:`shard_train_state` of ``make_train_state(params)`` for the
    global ``params``, made from this rank's slices of them, so that the
    global moments and master weights are never held."""
    if rules is None:
        return make_train_state(params, opt_cfg)
    state = make_train_state(shard_params(params, cfg, rules), opt_cfg)
    opt = {k: (v if k == "count" else tree_map(lambda x, sp: _local(x, sp, rules), v, specs["opt"][k]))
           for k, v in state["opt"].items()}
    return {"params": state["params"], "opt": opt, "step": state["step"]}


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _grads_of(params: Any, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags,
              shard: Optional[sharding.BatchShard] = None,
              ms: Optional[sharding.ModelShard] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, gradients) of ``local_loss`` at ``params`` on the rows
    ``batch``: JAX's ``value_and_grad(..., has_aux=True)`` (without
    ``shard``), or this rank's share of it.  A leaf the loss does not reach
    gets a zero gradient, as in JAX."""
    leaves = transformer._tree_leaves(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    it = iter(live)
    p = transformer._tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, ce, aux = transformer.local_loss(p, cfg, batch, flags, shard, ms)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(leaf) for g, leaf in zip(grads, leaves))
    return loss.detach(), {"ce": ce.detach(), "aux": aux.detach()}, transformer._tree_map(lambda _: next(it), params)


def _global_grads_of(params: Any, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags,
                     rules: Optional[MeshRules]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """:func:`_grads_of` of the global ``batch``: under ``rules`` this rank's
    rows, with the gradients summed over the data axes and the loss, ce and
    aux reduced to JAX's global values."""
    if rules is None:
        return _grads_of(params, cfg, batch, flags)
    shard = sharding.batch_shard(rules, batch["tokens"].shape[0])
    loss, metrics, grads = _grads_of(params, cfg, shard.take(batch), flags, shard, sharding.model_shard(rules))
    if not shard.sharded:  # every rank ran the whole batch
        return loss, metrics, grads
    grads = tree_map(torch.Tensor.contiguous, grads)
    for g in tree_leaves(grads):
        collectives.all_reduce_(g, shard.group)
    parts = collectives.all_reduce_(torch.stack([loss, metrics["ce"], metrics["aux"]]), shard.group)
    loss, ce, aux = parts.unbind(0)
    return loss, {"ce": ce, "aux": aux / shard.dp}, grads


def _grad_norm(grads: Any, specs: Optional[Dict[str, Any]], rules: Optional[MeshRules]) -> Optional[torch.Tensor]:
    """The global norm of the gradients of which this rank holds its
    model-axis slices (each sliced leaf's sum of squares added over the
    axis, in one call), in ``global_norm``'s order; None (``adamw_update``
    takes it from the gradients) on a model axis of one."""
    ms = sharding.model_shard(rules)
    if ms is None:
        return None
    sums = torch.stack([torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(grads)])
    split = torch.tensor([rules.tp_axis in tuple(sp) for sp in tree_leaves(specs["params"])], device=sums.device)
    summed = collectives.all_reduce_(torch.where(split, sums, torch.zeros_like(sums)), ms.group)
    return torch.sqrt(torch.sum(torch.where(split, summed, sums)))


def _zero1_update(grads: Any, state: Dict[str, Any], opt_cfg: AdamWConfig, lr: torch.Tensor,
                  specs: Dict[str, Any], rules: MeshRules) -> Tuple[Any, Dict[str, Any]]:
    """AdamW on this rank's shard of each leaf (clipped by the global norm
    of the whole gradients), then the new parameters gathered."""
    leaf_specs = specs["opt"]["m"]
    gnorm = _grad_norm(grads, specs, rules)
    shard = lambda x, sp: _local(x, sp, rules)  # noqa: E731
    new_shards, new_opt = adamw_update(tree_map(shard, grads, leaf_specs), state["opt"],
                                       tree_map(shard, state["params"], leaf_specs), opt_cfg, lr,
                                       gnorm=global_norm(grads) if gnorm is None else gnorm)
    return _gather_consuming(new_shards, leaf_specs, rules), new_opt


def _gather_consuming(shards: Dict[str, Any], specs: Dict[str, Any], rules: MeshRules) -> Dict[str, Any]:
    """:func:`_gather` over a tree, each shard let go once gathered (at most
    one leaf held twice)."""
    out = {}
    for k in list(shards):
        x = shards.pop(k)
        out[k] = _gather_consuming(x, specs[k], rules) if isinstance(x, dict) else _gather(x, specs[k], rules)
    return out


def make_train_step(
    cfg: ModelConfig,
    flags: RunFlags = DEFAULT_FLAGS,
    rules: Optional[MeshRules] = None,
    opt_cfg: AdamWConfig = AdamWConfig(),
    base_lr: float = 3e-4,
    total_steps: int = 10_000,
) -> Callable[[Dict[str, Any], Dict[str, torch.Tensor]], Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (new_state, metrics)`` with metrics
    ``loss``, ``lr``, ``ce`` and ``aux``.  Under ``rules`` every rank calls
    it with the same global batch and its own state (its slices of the
    leaves the model axis splits, and its ZeRO-1 shards under
    ``flags.zero1``: :func:`shard_train_state`); the metrics are the global
    ones."""
    transformer.check_supported(cfg, rules)
    sched = schedule_for(cfg, base_lr, total_steps)
    specs = train_state_specs(cfg, rules, opt_cfg, flags) if rules is not None else None

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        k = flags.grad_accum
        if k > 1:
            # microbatch over the leading batch dim; fp32 grad accumulator
            grads = tree_map(lambda l: torch.zeros(l.shape, dtype=torch.float32, device=l.device), state["params"])
            loss = torch.zeros((), dtype=torch.float32, device=state["step"].device)
            for i in range(k):
                mb = {n: a.reshape((k, a.shape[0] // k) + tuple(a.shape[1:]))[i] for n, a in batch.items()}
                mb_loss, metrics, g = _global_grads_of(state["params"], cfg, mb, flags, rules)
                grads = tree_map(lambda acc, gg: acc + gg.to(torch.float32) / k, grads, g)
                loss = loss + mb_loss / k
                del g
        else:
            loss, metrics, grads = _global_grads_of(state["params"], cfg, batch, flags, rules)
        lr = sched(state["step"])
        if not flags.zero1 or specs is None:
            new_params, new_opt = adamw_update(grads, state["opt"], state["params"], opt_cfg, lr,
                                               gnorm=_grad_norm(grads, specs, rules))
        else:
            new_params, new_opt = _zero1_update(grads, state, opt_cfg, lr, specs, rules)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "lr": lr, **metrics}

    return train_step


def jit_train_step(cfg, rules: MeshRules, flags: RunFlags, opt_cfg=AdamWConfig(), donate: bool = True):
    """(step, state specs): the counterpart of JAX's jitted, sharded step.
    There is no ``jit`` here: the step is :func:`make_train_step`'s SPMD
    step over the process group, each rank holding its state in the layout
    of the specs (:func:`shard_train_state`).  It consumes the state it is
    given (JAX's donation); ``donate=False`` updates a copy instead."""
    step = make_train_step(cfg, flags, rules, opt_cfg)
    sspecs = train_state_specs(cfg, rules, opt_cfg, flags)
    if donate:
        return step, sspecs
    return (lambda state, batch: step(tree_map(torch.clone, state), batch)), sspecs
