"""A DeepSeek-V3-architecture decoder (latent attention, sigmoid-routed
experts beside shared ones) with int8 weights and int8 activations in its
linears, plainly, in float32 with TF32 off: the equations the port's
serving path computes, written for the benchmark from the DeepSeek-V2/V3
papers (arXiv:2405.04434, arXiv:2412.19437) and the configuration.

Per layer, with ``h = n1(x)``: ``q = wq(h)`` split per head into a part
without position (``qk_nope_head_dim``) and one RoPE rotates
(``qk_rope_head_dim``); ``wkv_a(h)`` split into the latent ``c`` (RMSNorm'd
by ``kv_norm``) and a key part every head shares, RoPE'd; ``wkv_b(c)`` split
per head into the key part without position and the value
(``v_head_dim``); causal softmax attention over every position of the
(left-padded) rows, scaled by 1/sqrt(nope + rope); ``x += wo(attn)``.  Then
``h = n2(x)`` and, in the first ``first_k_dense_replace`` layers, ``x +=
down(silu(gate(h)) · up(h))``; in the rest the router's float32 logits
``h @ router``, their sigmoid scores, the ``num_experts_per_tok`` experts of
the highest score plus ``router_bias`` (chosen by it, weighted without it),
their scores normalised over the chosen (plus 1e-20) and times
``routed_scaling_factor``, and ``x += Σ weight · expert(h) + shared(h)``,
each expert and the shared one a SwiGLU.  The embedding is not scaled; a
final RMSNorm and the untied head on the last position.  RoPE rotates the
two halves of the rope part.  Each linear quantizes its input per row and
its weight per output column, symmetrically (scale ``max|·| / qmax``, at
least 1e-8, round half to even, clamped), multiplies the integers exactly
(int8 tensor cores where ``torch._int_mm`` takes the shape, else float64,
exact below 2**53) and dequantizes in float32; the router is a float32
product.

Routing is a comparison: a rounding of the program's bfloat16 activations
flips a near tie now and then (random weights leave near ties in every
layer), and past a flip the two forwards part by more than any tolerance of
the arithmetic.  So the reference can follow the program's choices
(``routes``): each expert layer then takes the program's experts, weighs
them by its own scores, and reports the routing gap, how far below its own
k-th choice value (score plus bias) a followed expert's lies.  A fault in
the program's routing shows in the gap; one elsewhere, in the logits.

Departures from the published Moonlight-16B-A3B, which the port makes too:
RoPE pairs halves, not interleaved columns (the same model after a fixed
permutation of the rope columns); the selection bias is drawn with the
weights; group-limited routing is left out (one group).

Weights (the harness's own tree, never the program's): ``{"embed": (V, d),
"final_norm": (d,), "lm_head": (d, V), "layers": [...]}``, each layer
``{"ln1", "ln2": (d,), "wq", "wkv_a", "wkv_b", "wo": (d_in, d_out),
"kv_norm": (r,)}`` and either the dense ``"w_gate", "w_up", "w_down"`` or
``"router": (d, E) float32, "router_bias": (E,) float32, "experts_gate_up":
(E, d, 2f) (gate the first f columns), "experts_down": (E, f, d),
"shared_gate", "shared_up": (d, fs), "shared_down": (fs, d)``.  Nothing of
the program is imported.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

FLOAT = ("ln1", "ln2", "kv_norm", "router", "router_bias")


def quantize_weight(w: torch.Tensor, bits: int) -> Dict[str, torch.Tensor]:
    """Per output column: ``{"q": int8 (…, K, N), "s": float32 (…, 1, N)}``."""
    wf = w.to(torch.float32)
    qmax = 2 ** (bits - 1) - 1
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp_min(amax / torch.full_like(amax, qmax), 1e-8)
    q = torch.clamp(torch.round(wf / s), -qmax - 1, qmax).to(torch.int8)
    return {"q": q, "s": s}


def quantize_weights(weights: dict, weight_bits: int) -> dict:
    """The weights with every linear quantized (the head too)."""
    def layer(lw):
        return {n: (t if n in FLOAT else quantize_weight(t, weight_bits)) for n, t in lw.items()}

    return {"embed": weights["embed"], "final_norm": weights["final_norm"],
            "lm_head": quantize_weight(weights["lm_head"], weight_bits),
            "layers": [layer(lw) for lw in weights["layers"]]}


def int_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 ``(M, K) @ (K, N)`` summed exactly, as float32-exact int32."""
    m, k = xq.shape
    n = wq.shape[1]
    if xq.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(xq.contiguous(), wq.contiguous()).to(torch.float32)
    return (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)


def qlinear(x: torch.Tensor, w: Dict[str, torch.Tensor], act_bits: int) -> torch.Tensor:
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    qmax = 2 ** (act_bits - 1) - 1
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.clamp_min(amax / torch.full_like(amax, qmax), 1e-8)
    xq = torch.clamp(torch.round(xf / xs), -qmax - 1, qmax).to(torch.int8)
    out = int_product(xq, w["q"]) * xs * w["s"].reshape(1, -1)
    return out.reshape(*lead, -1)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.to(torch.float32)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x`` (B, S, H, hd) rotated by position 0…S−1, halves paired."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None, None] * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x: torch.Tensor, gate: dict, up: dict, down: dict, act_bits: int) -> torch.Tensor:
    return qlinear(torch.nn.functional.silu(qlinear(x, gate, act_bits)) * qlinear(x, up, act_bits), down, act_bits)


def latent_attention(cfg: dict, lw: dict, h: torch.Tensor, act_bits: int) -> torch.Tensor:
    b, s, _ = h.shape
    heads, nope, rp = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, theta = cfg["kv_lora_rank"], cfg["rope_theta"]
    q = qlinear(h, lw["wq"], act_bits).reshape(b, s, heads, nope + rp)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    kv = qlinear(h, lw["wkv_a"], act_bits)
    c = rmsnorm(kv[..., :r], lw["kv_norm"], cfg["rms_norm_eps"])
    k_pe = rope(kv[..., None, r:], theta)
    kvb = qlinear(c, lw["wkv_b"], act_bits).reshape(b, s, heads, -1)
    k = torch.cat([kvb[..., :nope], k_pe.expand(b, s, heads, rp)], dim=-1)
    v = kvb[..., nope:]
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(nope + rp)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)
    return qlinear(out.reshape(b, s, -1), lw["wo"], act_bits)


def route(cfg: dict, lw: dict, h: torch.Tensor, follow=None):
    """(weights (T, k) float32, experts (T, k), gap) of the rows ``h`` (T,
    d): the experts of the k highest choice values (score plus bias), or
    with ``follow`` those experts (T, k), and ``gap``, the most by which a
    followed expert's choice value lies below the k-th highest (0 without
    ``follow``); either way weighted by this reference's own scores."""
    scores = torch.sigmoid(h @ lw["router"].to(torch.float32))
    choice = scores + lw["router_bias"]
    top = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1)
    gap = 0.0
    if follow is None:
        chosen = top.indices
    else:
        chosen = follow.to(device=h.device, dtype=torch.int64)
        gap = float((top.values[:, -1] - choice.gather(-1, chosen).amin(-1)).amax()) if len(h) else 0.0
    weights = scores.gather(-1, chosen)
    if cfg["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * cfg["routed_scaling_factor"], chosen, gap


def experts(cfg: dict, lw: dict, h: torch.Tensor, act_bits: int, follow=None):
    """(the routed and the shared experts' sum for the rows ``h`` (B, S, d),
    the experts chosen (B·S, k), the routing gap): :func:`route`'s."""
    b, s, d = h.shape
    x = h.reshape(-1, d)
    weights, chosen, gap = route(cfg, lw, x, follow)
    f = cfg["moe_intermediate_size"]
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if len(tok) == 0:
            continue
        gu, dn = lw["experts_gate_up"], lw["experts_down"]
        gate = {"q": gu["q"][e, :, :f], "s": gu["s"][e, :, :f]}
        up = {"q": gu["q"][e, :, f:], "s": gu["s"][e, :, f:]}
        y = swiglu(x[tok], gate, up, {"q": dn["q"][e], "s": dn["s"][e]}, act_bits)
        out.index_add_(0, tok, y * weights[tok, slot, None])
    shared = swiglu(x, lw["shared_gate"], lw["shared_up"], lw["shared_down"], act_bits)
    return (out + shared).reshape(b, s, d), chosen, gap


def last_logits(cfg: dict, qweights: dict, tokens: torch.Tensor, act_bits: int, routes=None):
    """(float32 logits ``(B, vocab_size)`` at the last position of each row
    of ``tokens`` (B, S), the experts chosen a layer, the routing gap):
    :func:`logits_at`'s.  ``qweights``: :func:`quantize_weights` of the
    weights."""
    logits, chosen, gap = logits_at(cfg, qweights, tokens, act_bits, [tokens.shape[1] - 1], routes)
    return logits[:, 0], chosen, gap


def logits_at(cfg: dict, qweights: dict, tokens: torch.Tensor, act_bits: int, positions: List[int], routes=None):
    """The full causal forward over ``tokens`` (B, S): (float32 logits ``(B,
    len(positions), vocab_size)`` at ``positions``, the experts each expert
    layer chose (B·S, k), the routing gap).  With ``routes`` (one (B·S, k)
    a layer) each expert layer takes those experts and the gap is the most
    by which one of them lies below the layer's own k-th choice
    (:func:`route`)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on: the reference's float32 products would round to TF32")
    eps, w = cfg["rms_norm_eps"], qweights
    x = w["embed"][tokens].to(torch.float32)
    chosen, gap = [], 0.0
    for i, lw in enumerate(w["layers"]):
        x = x + latent_attention(cfg, lw, rmsnorm(x, lw["ln1"], eps), act_bits)
        h = rmsnorm(x, lw["ln2"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(h, lw["w_gate"], lw["w_up"], lw["w_down"], act_bits)
        else:
            follow = None if routes is None else routes[len(chosen)]
            y, c, g = experts(cfg, lw, h, act_bits, follow)
            x, gap = x + y, max(gap, g)
            chosen.append(c)
    h = rmsnorm(x[:, positions], w["final_norm"], eps)
    return qlinear(h, w["lm_head"], act_bits)[..., : cfg["vocab_size"]], chosen, gap
