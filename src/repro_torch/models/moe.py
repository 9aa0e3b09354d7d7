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

:func:`dropless_moe_ffn` is the DeepSeek-V3 architecture's layer
(``configs.base.MLAMoEConfig``), which the JAX package does not have: sigmoid
scores, the top-k chosen by score plus a selection bias and weighted by
their scores normalised and scaled, every routed pair kept (dropless: a
token's output does not depend on the rest of the batch), and shared experts
beside the routed ones.  The routed pairs are sorted stably by expert, the
experts' row offsets found by ``searchsorted``, and each projection of all
the experts is one launch of the grouped bit-sliced GEMM
(``api.grouped_dequant_matmul``) over the sorted rows, behind the activation
quantize as in ``common.quant_linear``, which dequantizes in its epilogue
with each row's expert's column scales: no count is read on the host inside
the layer.  Spans: ``model.moe.route`` (scores, top-k, sort, offsets, the
rows' gather), ``model.moe.experts`` (the grouped products with their
quantize), ``model.moe.combine``; counters ``moe.routed_rows`` (tokens × k)
and, on the card, ``model.dequant.epilogue`` (one a grouped product).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch import obs
from repro_torch.dist import collectives
from repro_torch.kernels import api
from repro_torch.kernels.api import PrecisionSpec
from repro_torch.models.common import Params, dense_init, linear, linear_init, swiglu


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
    # one_hot's (G, Tg, E) by a compare: the same ops on every device (the
    # CPU's one_hot reads the ids' range on the host first)
    hot = (top1[..., None] == torch.arange(e, device=top1.device)).to(torch.float32)
    ce = torch.mean(hot, dim=1)  # (G, E) dispatch mass
    aux = e * torch.mean(torch.sum(me * ce, dim=-1))
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# dropless, sigmoid-routed experts with shared experts (MLAMoEConfig)
# ---------------------------------------------------------------------------

ROUTER_BIAS_STD = 0.05  # the selection bias init_params draws (not published)


def dropless_moe_init(gen, cfg, dtype, *, lead: tuple = (), device: Any) -> Params:
    """The router (float32, with its selection bias), the routed experts'
    stacks as linears of ``(*lead, E, d_in, d_out)`` (gate and up side by
    side in one) and the shared experts' SwiGLU."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    fs = cfg.n_shared_experts * f

    def experts(d_in, d_out):
        w = dense_init(gen, e * d_in, d_out, dtype, 1.0 / math.sqrt(d_in), lead=lead, device=device)
        return {"w": w.reshape(*lead, e, d_in, d_out)}

    bias = dense_init(gen, 1, e, torch.float32, ROUTER_BIAS_STD, lead=lead, device=device)
    return {
        "router": {"w": dense_init(gen, d, e, torch.float32, lead=lead, device=device),
                   "bias": bias.reshape(*lead, e)},
        "experts": {"gate_up": experts(d, 2 * f), "down": experts(f, d)},
        "shared": {"w_gate": linear_init(gen, d, fs, dtype, lead=lead, device=device),
                   "w_up": linear_init(gen, d, fs, dtype, lead=lead, device=device),
                   "w_down": linear_init(gen, fs, d, dtype, lead=lead, device=device)},
    }


def route_sigmoid(logits: torch.Tensor, bias: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (T, k) float32, experts (T, k)) of float32 router ``logits``
    (T, E): the k experts of the highest sigmoid score plus ``bias`` (the
    selection bias chooses and does not weigh), weighted by their scores,
    normalised over the k where ``norm_topk_prob``, times
    ``routed_scaling_factor``."""
    if cfg.scoring_func != "sigmoid" or cfg.n_group != 1 or cfg.topk_group != 1:
        raise NotImplementedError(f"{cfg.name}: dropless routing takes sigmoid scores in one group, got "
                                  f"{cfg.scoring_func!r}, n_group={cfg.n_group}, topk_group={cfg.topk_group}")
    scores = torch.sigmoid(logits)
    experts = torch.topk(scores + bias, cfg.experts_per_token, dim=-1).indices
    weights = scores.gather(-1, experts)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * cfg.routed_scaling_factor, experts


def sort_by_expert(experts: torch.Tensor, n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed pairs (``experts (T, k)`` flattened) in a stable order by
    expert: (order, offsets (E + 1,) int32 where expert e's pairs are
    ``offsets[e]`` to ``offsets[e + 1]``)."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    offsets = torch.searchsorted(flat[order], torch.arange(n_experts + 1, device=flat.device)).to(torch.int32)
    return order, offsets


def _grouped_linear(p: Params, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Each sorted row of ``x`` through its expert's linear of ``p``: the
    grouped bit-sliced GEMM behind the activation quantize (int8, as
    ``common.linear``'s), dequantized in its epilogue (each row's scale
    times its expert's column scales) when ``p`` is quantized, else float
    products, an expert at a time."""
    if "w" in p:
        out = x.new_empty((x.shape[0], p["w"].shape[-1]))
        bounds = offsets.tolist()
        for e in range(p["w"].shape[0]):
            out[bounds[e]:bounds[e + 1]] = x[bounds[e]:bounds[e + 1]] @ p["w"][e]
        return out
    with obs.span("model.act_quant"):
        x_q, x_scale = api.act_quant(x, PrecisionSpec.int8.act_bits)
    if x.device.type == "cuda":
        obs.count("model.dequant.epilogue")
    return api.grouped_dequant_matmul(x_q, p["w_q"], offsets, x_scale, p["w_scale"], x.dtype)


def dropless_moe_ffn(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (routed + shared experts' output, 0: no aux loss).
    Every token's k routed pairs are kept; the combine sums a token's k
    expert outputs in float32, weighted, in its own order, so the output of
    a token does not depend on the other tokens of the batch."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    xf = x.reshape(-1, d)
    with obs.span("model.moe.route"):
        logits = xf.to(torch.float32) @ p["router"]["w"]
        weights, experts = route_sigmoid(logits, p["router"]["bias"], cfg)
        order, offsets = sort_by_expert(experts, cfg.n_experts)
        rows = xf[order // k]
    obs.count("moe.routed_rows", rows.shape[0])
    with obs.span("model.moe.experts"):
        gu = _grouped_linear(p["experts"]["gate_up"], rows, offsets)
        f = gu.shape[-1] // 2
        y = _grouped_linear(p["experts"]["down"], swiglu(gu[:, :f], gu[:, f:]), offsets)
    sh = p["shared"]
    shared = linear(sh["w_down"], swiglu(linear(sh["w_gate"], x), linear(sh["w_up"], x)))
    with obs.span("model.moe.combine"):
        pairs = y.new_empty(y.shape).index_copy_(0, order, y)  # back in (token, choice) order
        routed = (pairs.view(-1, k, d).to(torch.float32) * weights[..., None]).sum(1).to(x.dtype)
        out = routed.view(b, s, d) + shared
    return out, torch.zeros((), dtype=torch.float32, device=x.device)
