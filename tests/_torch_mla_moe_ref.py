"""A plain float32 reference of the DeepSeek-V3 architecture the port serves
(``configs.base.MLAMoEConfig``): latent attention, a dense SwiGLU in the
leading layers, sigmoid-routed experts beside shared ones in the rest;
written from the DeepSeek-V2/V3 papers (arXiv:2405.04434, 2412.19437), in
plain ``torch``, importing no JAX and nothing of the port.

It reads the port's parameter tree (float weights, one pattern group) and
computes the full causal forward, every token's routing on its own.  With
``bits`` each linear quantizes its input per row and its weight per output
column symmetrically (scale ``max|·| / qmax``, at least 1e-8, round half to
even) and multiplies the integers exactly in float64; without, it is a
float32 product.  The router is a float32 product either way.
"""
import math

import torch


def _linear(x, w, bits):
    w = w.to(torch.float32)
    if bits is None:
        return x @ w
    qmax = 2 ** (bits - 1) - 1
    ws = torch.clamp_min(w.abs().amax(0, keepdim=True) / qmax, 1e-8)
    wq = torch.clamp(torch.round(w / ws), -qmax - 1, qmax)
    xf = x.reshape(-1, x.shape[-1])
    xs = torch.clamp_min(xf.abs().amax(-1, keepdim=True) / 127, 1e-8)
    xq = torch.clamp(torch.round(xf / xs), -128, 127)
    out = (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32) * xs * ws
    return out.reshape(*x.shape[:-1], -1)


def _norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.to(torch.float32)


def _rope(x, theta):
    """``x`` (B, S, H, d) rotated by position, its halves paired."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = torch.arange(s, dtype=torch.float32)[:, None, None] * freqs
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang), x2 * torch.cos(ang) + x1 * torch.sin(ang)], -1)


def _swiglu(x, gate, up, down, bits):
    return _linear(torch.nn.functional.silu(_linear(x, gate, bits)) * _linear(x, up, bits), down, bits)


def _attention(cfg, p, h, bits):
    b, s, _ = h.shape
    nh, nope, rp, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    q = _linear(h, p["wq"]["w"], bits).reshape(b, s, nh, nope + rp)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cfg.rope_theta)], -1)
    kv = _linear(h, p["wkv_a"]["w"], bits)
    latent = _norm(kv[..., :r], p["kv_norm"]["scale"], cfg.norm_eps)
    k_pe = _rope(kv[..., None, r:], cfg.rope_theta)
    kvb = _linear(latent, p["wkv_b"]["w"], bits).reshape(b, s, nh, -1)
    k = torch.cat([kvb[..., :nope], k_pe.expand(b, s, nh, rp)], -1)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(nope + rp)
    scores = scores.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, -1), kvb[..., nope:])
    return _linear(out.reshape(b, s, -1), p["wo"]["w"], bits)


def route(cfg, router, x):
    """(weights (T, k), experts (T, k)) of the rows ``x`` (T, d), a token at a
    time: the k highest sigmoid scores plus the bias, weighted by their
    scores normalised and scaled."""
    weights, chosen = [], []
    for row in x.to(torch.float32):
        scores = torch.sigmoid(row @ router["w"])
        pick = torch.topk(scores + router["bias"], cfg.experts_per_token).indices
        w = scores[pick]
        if cfg.norm_topk_prob:
            w = w / (w.sum() + 1e-20)
        weights.append(w * cfg.routed_scaling_factor)
        chosen.append(pick)
    return torch.stack(weights), torch.stack(chosen)


def moe(cfg, p, x, bits):
    """The routed experts' weighted sum and the shared experts, token by token."""
    b, s, d = x.shape
    rows = x.reshape(-1, d)
    weights, chosen = route(cfg, p["router"], rows)
    f = cfg.moe_d_ff
    gu, dn = p["experts"]["gate_up"]["w"], p["experts"]["down"]["w"]
    out = []
    for t in range(rows.shape[0]):
        y = torch.zeros(d)
        for w, e in zip(weights[t], chosen[t]):
            y = y + w * _swiglu(rows[t:t + 1], gu[e][:, :f], gu[e][:, f:], dn[e], bits)[0]
        out.append(y)
    sh = p["shared"]
    shared = _swiglu(rows, sh["w_gate"]["w"], sh["w_up"]["w"], sh["w_down"]["w"], bits)
    return (torch.stack(out) + shared).reshape(b, s, d)


def forward(cfg, params, tokens, bits=None):
    """float32 logits (B, S, V) of the port's float ``params`` (one pattern
    group) over ``tokens`` (B, S)."""
    x = params["embed"]["w"][tokens].to(torch.float32)
    for i, kind in enumerate(cfg.block_pattern):
        p = {k: _group0(v) for k, v in params["blocks"][f"{i:02d}_{kind}"].items()}
        x = x + _attention(cfg, p["attn"], _norm(x, p["ln1"]["scale"], cfg.norm_eps), bits)
        h = _norm(x, p["ln2"]["scale"], cfg.norm_eps)
        if kind == "mla":
            f = p["ffn"]
            x = x + _swiglu(h, f["w_gate"]["w"], f["w_up"]["w"], f["w_down"]["w"], bits)
        else:
            x = x + moe(cfg, p["ffn"], h, bits)
    h = _norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return _linear(h, params["lm_head"]["w"], bits)


def _group0(tree):
    if isinstance(tree, dict):
        return {k: _group0(v) for k, v in tree.items()}
    return tree[0].to(torch.float32)
