"""AdamW with bf16 params + fp32 master/moments, and the WSD
(warmup-stable-decay) schedule MiniCPM trains with: the PyTorch port of the
JAX package's ``train/optimizer.py``.

Hand-rolled on dict trees of tensors.  Optimizer state:
``{"m", "v", "master", "count"}`` — ``master`` holds fp32 weights when params
are low-precision (mixed-precision training standard practice).

Every op is JAX's, in its order (``optimizer.py:46–79``): the clip scale, the
moments, the bias corrections, the update of the float32 source, then the
cast back to the parameter dtype.  Leaves are taken in sorted key order, as
``jax.tree_util`` flattens a dict.  :func:`adamw_update` updates the state's
``m``, ``v`` and ``master`` leaves in place, as the JAX trainer donates the
train state (``donate_argnums``): at RecurrentGemma-2B's 2.9 B parameters a
second copy of the float32 state would not fit an 80 GB card.  A scalar
divisor that is a device tensor (``bc1``, ``bc2``) divides as XLA does;
Python-number divisors are written as JAX writes them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    keep_master: bool = True


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict in sorted key order (``jax.tree_util``'s
    order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of the
    same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    f32 = lambda l: torch.zeros(l.shape, dtype=torch.float32, device=l.device)
    state = {"m": tree_map(f32, params), "v": tree_map(f32, params)}
    some = tree_leaves(params)[0]
    state["count"] = torch.zeros((), dtype=torch.int32, device=some.device)
    if cfg.keep_master:
        state["master"] = tree_map(lambda l: l.to(torch.float32, copy=True), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(l.to(torch.float32))) for l in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def adamw_update(grads: Any, state: Dict[str, Any], params: Any, cfg: AdamWConfig,
                 lr: torch.Tensor, gnorm: Optional[torch.Tensor] = None) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step.  Returns ``(new_params, new_state)``; ``state``'s
    ``m``, ``v`` and ``master`` leaves are updated in place and reappear in
    ``new_state`` (the caller passes the state on, as a donated one).
    ``gnorm`` is the gradients' global norm when ``grads`` are shards of
    them (ZeRO-1); by default it is taken from ``grads``."""
    count = state["count"] + 1
    gn = global_norm(grads) if gnorm is None else gnorm
    scale = torch.minimum(_scalar(1.0, gn), _scalar(cfg.grad_clip, gn) / torch.maximum(gn, _scalar(1e-12, gn)))
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(_scalar(cfg.b1, cf), cf)
    bc2 = 1.0 - torch.pow(_scalar(cfg.b2, cf), cf)
    keep = "master" in state
    source = state["master"] if keep else params

    def upd(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        gg = (1 - cfg.b2) * g
        v.mul_(cfg.b2).add_(gg.mul_(g))
        del g, gg
        step = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        pf = p if keep else p.to(torch.float32, copy=True)
        step.add_(cfg.weight_decay * pf)
        pf.sub_(lr * step)
        return pf

    masters = tree_map(upd, grads, state["m"], state["v"], source)
    new_params = tree_map(lambda f, p: f.to(p.dtype, copy=True), masters, params)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    if keep:
        new_state["master"] = masters
    return new_params, new_state


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def wsd_schedule(base_lr: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Warmup-Stable-Decay (MiniCPM): linear warmup → constant → exp decay."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * torch.clamp((step + 1.0) / _scalar(max(warmup, 1), step), max=1.0)
        in_decay = torch.clamp(step - warmup - stable, min=0.0)
        frac = torch.clamp(in_decay / _scalar(max(decay, 1), step), max=1.0)
        decayed = base_lr * torch.pow(_scalar(floor, step), frac)
        return torch.where(step < warmup + stable, warm, decayed)

    return lr


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * torch.clamp((step + 1.0) / _scalar(max(warmup, 1), step), max=1.0)
        t = torch.clamp((step - warmup) / _scalar(max(total - warmup, 1), step), 0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr


def schedule_for(cfg, base_lr: float = 3e-4, total_steps: int = 10_000) -> Callable[[torch.Tensor], torch.Tensor]:
    if getattr(cfg, "wsd_schedule", False):
        return wsd_schedule(base_lr, total_steps // 100 + 1, int(total_steps * 0.8), int(total_steps * 0.19) + 1)
    return cosine_schedule(base_lr, total_steps // 100 + 1, total_steps)
