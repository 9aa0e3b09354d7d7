"""A dense decoder with int8 weights and int8 activations in its linears,
plainly, in float32 with TF32 off: the equations the port's serving path
computes, written for the benchmark.

Per layer: ``x += o(attn(rope(q(n1(x))), rope(k(n1(x))), v(n1(x))))`` with
causal softmax attention over every position of the (left-padded) rows,
then ``x += down(silu(gate(n2(x))) · up(n2(x)))``; the embedding scaled by
sqrt(hidden_size) in front, a final RMSNorm and the head (the embedding's
transpose when tied) on the last position.  RoPE rotates the two halves of
each head.  Each linear quantizes its input per row and its weight per
output column, symmetrically (scale ``max|·| / qmax``, at least 1e-8,
round half to even, clamped), multiplies the integers exactly (int8 tensor
cores where ``torch._int_mm`` takes the shape, else float64, exact below
2**53) and dequantizes in float32.

Departures from the published MiniCPM-2B, which the port makes too: the
embedding is scaled by sqrt(hidden_size) and not by ``scale_emb``, the
residual branches are not scaled by ``scale_depth / sqrt(layers)`` and the
logits are not divided by ``hidden_size / dim_model_base``.

Weights (the harness's own tree, never the program's): ``{"embed": (V', d),
"ln1", "ln2": (L, d), "wq", "wk", "wv": (L, d, ·), "wo": (L, q, d),
"w_gate", "w_up": (L, d, f), "w_down": (L, f, d), "final_norm": (d,),
"lm_head"?: (d, V')}``.  Nothing of the program is imported.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_weight(w: torch.Tensor, bits: int) -> Dict[str, torch.Tensor]:
    """Per output column: ``{"q": int8 (…, K, N), "s": float32 (…, 1, N)}``."""
    wf = w.to(torch.float32)
    qmax = 2 ** (bits - 1) - 1
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp_min(amax / torch.full_like(amax, qmax), 1e-8)
    q = torch.clamp(torch.round(wf / s), -qmax - 1, qmax).to(torch.int8)
    return {"q": q, "s": s}


def quantize_weights(weights: dict, weight_bits: int) -> dict:
    """The weights with every linear quantized (the head too when untied)."""
    out = dict(weights)
    for name in LINEARS + (("lm_head",) if "lm_head" in weights else ()):
        out[name] = quantize_weight(weights[name], weight_bits)
    return out


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention; q (B, S, H, hd), k and v (B, S, Hkv, hd)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)


def last_logits(cfg: dict, qweights: dict, tokens: torch.Tensor, act_bits: int) -> torch.Tensor:
    """float32 logits ``(B, vocab_size)`` at the last position of each row of
    ``tokens`` (B, S), over the model's own vocabulary (not its padding).
    ``qweights``: :func:`quantize_weights` of the weights."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on: the reference's float32 products would round to TF32")
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
    b, s = tokens.shape
    w = qweights
    x = w["embed"][tokens].to(torch.float32) * math.sqrt(cfg["hidden_size"])
    for layer in range(cfg["num_hidden_layers"]):
        lw = {n: {"q": w[n]["q"][layer], "s": w[n]["s"][layer]} for n in LINEARS}
        h = rmsnorm(x, w["ln1"][layer], eps)
        q = rope(qlinear(h, lw["wq"], act_bits).reshape(b, s, -1, hd), theta)
        k = rope(qlinear(h, lw["wk"], act_bits).reshape(b, s, -1, hd), theta)
        v = qlinear(h, lw["wv"], act_bits).reshape(b, s, -1, hd)
        x = x + qlinear(attention(q, k, v).reshape(b, s, -1), lw["wo"], act_bits)
        h = rmsnorm(x, w["ln2"][layer], eps)
        gate, up = qlinear(h, lw["w_gate"], act_bits), qlinear(h, lw["w_up"], act_bits)
        x = x + qlinear(torch.nn.functional.silu(gate) * up, lw["w_down"], act_bits)
    h = rmsnorm(x[:, -1], w["final_norm"], eps)
    vocab = cfg["vocab_size"]
    if cfg["tie_word_embeddings"]:
        return h @ w["embed"][:vocab].to(torch.float32).T
    return qlinear(h, w["lm_head"], act_bits)[:, :vocab]
