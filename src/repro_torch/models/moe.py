"""Mixture-of-Experts FFN of the PyTorch port, with sort-based capacity
dispatch: the port's copy of the JAX package's ``models/moe.py``.

Routing runs independently per *routing group* (JAX maps the groups with
``vmap``; here a loop over them).  Dispatch is gather/scatter-based: the
routed (token, expert) pairs are sorted stably by expert id, each pair's
position within its expert's segment comes from a ``searchsorted``, pairs
past the capacity are dropped, and the kept tokens are copied into an
``(E·C, D)`` buffer that feeds a batched expert product.  Which tokens
overflow depends on that stable order, so the integer routing (slots,
tokens, kept flags) equals JAX's exactly on equal logits.

The expert weights are raw ``(E, d, f)`` arrays, which the serving form
(``maybe_quantize_tree``) leaves float, and the JAX package multiplies them
with ``jnp.einsum`` outside any kernel: here ``torch.einsum``.  The combine
is an ``index_add_``, atomic on CUDA: the card adds a token's expert outputs
in another order than the CPU, so the two agree within a float tolerance,
not bit for bit.

On a "model" axis wider than one that the experts divide, a rank holds
``E/tp`` experts: the router, the capacity and the dispatch stay replicated
(every rank routes identically), the rank runs its experts on their buffer
rows, and the expert outputs are gathered over the axis before the combine.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch.dist import collectives
from repro_torch.models.common import Params, dense_init, swiglu


def moe_init(gen, cfg, dtype, *, lead: tuple = (), device: Any) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": {"w": dense_init(gen, d, e, torch.float32, lead=lead, device=device)},
        "w_gate": dense_init(gen, e * d, f, dtype, lead=lead, device=device).reshape(*lead, e, d, f),
        "w_up": dense_init(gen, e * d, f, dtype, lead=lead, device=device).reshape(*lead, e, d, f),
        "w_down": dense_init(gen, e * f, d, dtype, lead=lead, device=device).reshape(*lead, e, f, d),
    }


def _route_group(x: torch.Tensor, logits: torch.Tensor, k: int, capacity: int):
    """Single routing group.  x: (T, D); logits: (T, E) float32.

    Returns (buf (E*C, D), (slot, st, sg, keep)) for the gather-based
    un-dispatch: each routed pair's buffer row (E*C for a dropped pair), its
    token, its gate and whether it was kept, in the stable expert order."""
    t, e = logits.shape
    dev = logits.device
    # jax.lax.top_k: descending, the lower expert first among equal logits;
    # a stable descending sort gives that order (torch.topk leaves ties unordered)
    gates, eidx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :k], eidx[:, :k]  # (T,k)
    gates = torch.softmax(gates, dim=-1)
    flat_e = eidx.reshape(-1)  # (T*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    # position of each routed pair within its expert's segment
    seg_start = torch.searchsorted(se, torch.arange(e, device=dev), right=False)  # (E,)
    pos = torch.arange(t * k, device=dev) - seg_start[se]
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, torch.full_like(se, e * capacity))  # overflow row
    # duplicate slots only ever land on the overflow row, which is cut off
    buf = x.new_zeros((e * capacity + 1, x.shape[-1])).index_copy_(0, slot, x[st])
    return buf[: e * capacity], (slot, st, sg, keep)


def _combine_group(y: torch.Tensor, info, t: int) -> torch.Tensor:
    """y: (E*C, D_out) expert outputs -> (T, D_out)."""
    slot, st, sg, keep = info
    contrib = y[torch.where(keep, slot, torch.zeros_like(slot))]
    contrib = contrib * torch.where(keep, sg, torch.zeros_like(sg)).to(contrib.dtype)[:, None]
    return y.new_zeros((t, y.shape[-1])).index_add_(0, st, contrib)


def moe_ffn(p: Params, x: torch.Tensor, cfg, n_groups: int, ms=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Routed per group of B*S/n_groups
    tokens.  ``ms`` (a ``dist.sharding.ModelShard``): the experts this rank
    holds when ``p``'s expert stacks are its slices of them."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    tokens = b * s
    if tokens % n_groups:
        raise ValueError(f"{tokens} tokens do not split into {n_groups} routing groups")
    tg = tokens // n_groups
    capacity = max(k, int(math.ceil(tg * k / e * cfg.moe_capacity_factor)))
    xg = x.reshape(n_groups, tg, d)
    logits = xg.to(torch.float32) @ p["router"]["w"]  # (G, Tg, E)
    el = p["w_gate"].shape[0]
    split = ms is not None and el != e
    outs = []
    for xi, li in zip(xg, logits):
        buf, info = _route_group(xi, li, k, capacity)
        buf = buf.reshape(e, capacity, d)
        if split:  # this rank's experts' rows
            buf = collectives.copy_to_model(buf, ms).narrow(0, ms.start(e), el)
        gate = torch.einsum("ecd,edf->ecf", buf, p["w_gate"])
        up = torch.einsum("ecd,edf->ecf", buf, p["w_up"])
        act = swiglu(gate, up)
        down = torch.einsum("ecf,efd->ecd", act, p["w_down"])
        if split:
            down = collectives.gather_from_model(down, 0, ms)
        outs.append(_combine_group(down.reshape(e * capacity, d), info, tg))
    out = torch.stack(outs)
    # Switch-style load-balance aux loss
    probs = torch.softmax(logits, dim=-1)  # (G, Tg, E)
    me = torch.mean(probs, dim=1)  # (G, E) router probability mass
    top1 = torch.argmax(logits, dim=-1)
    ce = torch.mean(torch.nn.functional.one_hot(top1, e).to(torch.float32), dim=1)  # (G, E) dispatch mass
    aux = e * torch.mean(torch.sum(me * ce, dim=-1))
    return out.reshape(b, s, d), aux
