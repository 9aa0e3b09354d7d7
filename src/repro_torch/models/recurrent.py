"""Recurrent temporal-mixing blocks of the PyTorch port: RG-LRU
(RecurrentGemma/Griffin) and the xLSTM pair (chunkwise-parallel mLSTM,
sequential sLSTM); the port's copy of the JAX package's
``models/recurrent.py``.

All recurrences run in float32 with log-space gate stabilization.  Each
block has two execution forms:

* sequence form (prefill): the RG-LRU recurrence on the RG-LRU scan kernel
  (``api.rglru_scan``, from the carried state or zeros), where the JAX
  package runs ``jax.lax.associative_scan``; the mLSTM chunkwise-parallel
  (a Python loop over chunks where JAX runs ``lax.scan``); the sLSTM a
  Python loop over time.
* single-step form (decode): a fixed-size state, elementwise for the
  RG-LRU (no kernel launch), as in JAX.

Every op is the JAX package's op in its order: the width-4 causal
convolution is four multiply-adds in the input dtype (``F.conv1d`` would
accumulate in float32), ``jax.nn.gelu`` is the tanh approximation and
``jax.nn.softplus`` / ``log_sigmoid`` are ``logaddexp`` forms.

On a "model" axis wider than one (``ms``, a ``dist.sharding.ModelShard``)
the sharding rules shard only the xLSTM mixers' ``w_up`` (columns) and
``w_down`` (rows), whose names the FFN shares: ``w_up``'s output is a
concatenation (``[x_m | z]``, the GeGLU halves) that a column slice would
split wrongly, so it is gathered whole; ``w_down`` takes its slice of the
replicated input and adds the partial sums over the axis.  Everything else,
the RG-LRU mixer whole, replicates.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import api
from repro_torch.models.common import Params, dtype_of, linear, linear_init, tp_gathered, tp_linear

# ---------------------------------------------------------------------------
# causal conv1d (width-K depthwise), used by RG-LRU and mLSTM blocks
# ---------------------------------------------------------------------------

CONV_K = 4


def causal_conv1d(u: torch.Tensor, kernel: torch.Tensor, state: Optional[torch.Tensor] = None):
    """u: (B,S,W); kernel: (K,W) depthwise.  state: (B,K-1,W) trailing inputs
    of the previous segment.  Returns (y, new_state)."""
    b, s, w = u.shape
    k = kernel.shape[0]
    if state is None:
        state = u.new_zeros((b, k - 1, w))
    ext = torch.cat([state, u], dim=1)  # (B, S+K-1, W)
    y = torch.zeros_like(u)
    for j in range(k):
        y = y + ext[:, j:j + s] * kernel[j]
    return y, ext[:, -(k - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.log_sigmoid is -softplus(-x)
    return -_softplus(-x)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _randn(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def rglru_block_init(gen, cfg, dtype, *, lead: tuple = (), device: Any) -> Params:
    d = cfg.d_model
    w = d  # lru_width == d_model in RecurrentGemma
    return {
        "w_gate_branch": linear_init(gen, d, w, dtype, lead=lead, device=device),
        "w_rec_branch": linear_init(gen, d, w, dtype, lead=lead, device=device),
        "conv": {"kernel": (_randn(gen, (*lead, CONV_K, w), device) * 0.1).to(dtype)},
        "w_a": linear_init(gen, w, w, dtype, lead=lead, device=device),  # recurrence gate
        "w_i": linear_init(gen, w, w, dtype, lead=lead, device=device),  # input gate
        "lambda": torch.full((*lead, w), 2.0, dtype=torch.float32, device=device),  # softplus(2)≈2.1
        "w_out": linear_init(gen, w, d, dtype, lead=lead, device=device),
    }


def _rglru_coeffs(p: Params, u: torch.Tensor):
    """u: (..., W) conv output -> (log_a, x_in) in float32."""
    r = torch.sigmoid(linear(p["w_a"], u).to(torch.float32))
    i = torch.sigmoid(linear(p["w_i"], u).to(torch.float32))
    log_a = -_RGLRU_C * _softplus(p["lambda"]) * r
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))  # sqrt(1 - a^2), stable
    x_in = beta * (i * u.to(torch.float32))
    return log_a, x_in


def rglru_block_apply(p: Params, x: torch.Tensor, cfg, state: Optional[Dict] = None, ms=None):
    """x: (B,S,d).  Returns (y, new_state) with state {"h": (B,W), "conv": (B,K-1,W)}.
    Its leaves replicate on any mesh: ``ms`` changes nothing.

    The sequence form runs ``h_t = a_t·h_{t-1} + x_in_t`` on the RG-LRU scan
    kernel from ``state["h"]`` (or zeros): JAX adds ``a_0·h`` into
    ``x_in_0`` and scans associatively, the same recurrence."""
    gate = _gelu(linear(p["w_gate_branch"], x).to(torch.float32)).to(x.dtype)
    u0 = linear(p["w_rec_branch"], x)
    conv_state = state["conv"] if state else None
    u, conv_state = causal_conv1d(u0, p["conv"]["kernel"], conv_state)
    log_a, x_in = _rglru_coeffs(p, u)
    if x.shape[1] == 1 and state is not None:  # decode step
        h = state["h"] * torch.exp(log_a[:, 0]) + x_in[:, 0]
        hs = h[:, None]
    else:
        a = torch.exp(log_a)
        h0 = state["h"] if state is not None else x_in.new_zeros((x.shape[0], x.shape[2]))
        # JAX scans outside the kernel registry: run on the operands' device
        # in any backend scope
        with api.on_device():
            hs = api.rglru_scan(a.contiguous(), x_in.contiguous(), h0.to(torch.float32).contiguous())
        h = hs[:, -1]
    y = linear(p["w_out"], (gate.to(torch.float32) * hs).to(x.dtype))
    return y, {"h": h, "conv": conv_state}


def rglru_state_init(cfg, batch: int, *, lead: tuple = (), device: Any = None) -> Dict:
    w = cfg.d_model
    return {
        "h": torch.zeros((*lead, batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, CONV_K - 1, w), dtype=dtype_of(cfg), device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory) — chunkwise parallel
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg) -> Tuple[int, int, int]:
    pf = 2 * cfg.d_model  # projection factor 2
    h = cfg.n_heads
    return pf, h, pf // h


def mlstm_block_init(gen, cfg, dtype, *, lead: tuple = (), device: Any) -> Params:
    d = cfg.d_model
    pf, h, _ = _mlstm_dims(cfg)
    return {
        "w_up": linear_init(gen, d, 2 * pf, dtype, lead=lead, device=device),  # [x_m | z-gate]
        "conv": {"kernel": (_randn(gen, (*lead, CONV_K, pf), device) * 0.1).to(dtype)},
        "w_q": linear_init(gen, pf, pf, dtype, lead=lead, device=device),
        "w_k": linear_init(gen, pf, pf, dtype, lead=lead, device=device),
        "w_v": linear_init(gen, pf, pf, dtype, lead=lead, device=device),
        "w_if": linear_init(gen, pf, 2 * h, dtype, lead=lead, device=device),  # per-head scalar gates
        "gn_scale": torch.ones((*lead, pf), dtype=dtype, device=device),
        "w_down": linear_init(gen, pf, d, dtype, lead=lead, device=device),
    }


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:  # (B,S,pf) -> (B,S,H,dh)
    b, s, _ = x.shape
    return x.reshape(b, s, h, -1)


def _pad_axis1(x: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    return torch.cat([x, x.new_full((x.shape[0], pad, *x.shape[2:]), value)], dim=1)


def _mlstm_chunk_scan(q, k, v, ig, lf, state, chunk: int):
    """Chunkwise stabilized mLSTM.

    q,k,v: (B,S,H,dh), q pre-scaled by 1/sqrt(dh).
    ig, lf: (B,S,H) log input gate (ĩ) and log forget gate (logsigmoid f̃).
    state: dict C (B,H,dh,dh), n (B,H,dh), m (B,H).
    Returns (y (B,S,H,dh), new_state).
    """
    b, s, h, dh = q.shape
    l = min(chunk, s)
    pad = (-s) % l
    if pad:
        q, k, v = (_pad_axis1(t, pad) for t in (q, k, v))
        ig = _pad_axis1(ig, pad, -1e30)
        lf = _pad_axis1(lf, pad)
    sp = s + pad
    nc = sp // l
    # (nc, B, H, L, ...) layout, one chunk a step
    qc = q.reshape(b, nc, l, h, dh).permute(1, 0, 3, 2, 4)
    kc = k.reshape(b, nc, l, h, dh).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, nc, l, h, dh).permute(1, 0, 3, 2, 4)
    igc = ig.reshape(b, nc, l, h).permute(1, 0, 3, 2)  # (nc,B,H,L)
    lfc = lf.reshape(b, nc, l, h).permute(1, 0, 3, 2)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    C, n, m = state["C"], state["n"], state["m"]  # (B,H,dh,dh), (B,H,dh), (B,H)
    ys = []
    for c in range(nc):
        qi, ki, vi, ii, fi = qc[c], kc[c], vc[c], igc[c], lfc[c]
        bcum = torch.cumsum(fi, dim=-1)  # (B,H,L) inclusive log-decay F_t
        g = ii - bcum  # g_s = ĩ_s - F_s
        gmax = torch.cummax(g, dim=-1).values
        m_t = torch.maximum(m[..., None] + bcum, bcum + gmax)  # (B,H,L)
        # inter-chunk: queries read the incoming state
        dec_in = torch.exp(m[..., None] + bcum - m_t)  # (B,H,L)
        y_inter = torch.einsum("bhld,bhde->bhle", qi, C) * dec_in[..., None]
        n_inter = torch.einsum("bhld,bhd->bhl", qi, n) * dec_in
        # intra-chunk: D_ts = exp(F_t - F_s + ĩ_s - m_t), s <= t
        logd = bcum[..., :, None] - bcum[..., None, :] + ii[..., None, :] - m_t[..., None]
        logd = torch.where(tri, logd, torch.full_like(logd, -1e30))
        d_mat = torch.exp(logd)  # (B,H,L,L)
        s_mat = torch.einsum("bhld,bhsd->bhls", qi, ki) * d_mat
        y_intra = torch.einsum("bhls,bhsd->bhld", s_mat, vi)
        n_intra = torch.sum(s_mat, dim=-1)
        denom = torch.maximum(torch.abs(n_inter + n_intra), torch.exp(-m_t))[..., None]
        ys.append((y_inter + y_intra) / denom)  # (B,H,L,dh)
        # state update to the end of the chunk
        btot = bcum[..., -1]  # (B,H)
        m_new = torch.maximum(m + btot, btot + gmax[..., -1])
        w_state = torch.exp(m + btot - m_new)  # old-state decay
        w_in = torch.exp(btot[..., None] - bcum + ii - m_new[..., None])  # (B,H,L)
        C = C * w_state[..., None, None] + torch.einsum("bhl,bhld,bhle->bhde", w_in, ki, vi)
        n = n * w_state[..., None] + torch.einsum("bhl,bhld->bhd", w_in, ki)
        m = m_new
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, sp, h, dh)[:, :s]
    return y, {"C": C, "n": n, "m": m}


def _mlstm_decode_step(q, k, v, ig, lf, state):
    """Single step.  q,k,v: (B,H,dh); ig,lf: (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, ig)
    f_w = torch.exp(lf + m - m_new)
    i_w = torch.exp(ig - m_new)
    C = C * f_w[..., None, None] + i_w[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = n * f_w[..., None] + i_w[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), torch.exp(-m_new))
    y = num / denom[..., None]
    return y, {"C": C, "n": n, "m": m_new}


def _groupnorm_heads(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMS norm over dh (no mean-centering).  x: (B,S,H,dh)."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps)


def mlstm_block_apply(p: Params, x: torch.Tensor, cfg, state: Optional[Dict] = None, chunk: int = 256,
                      ms=None):
    b, s, d = x.shape
    pf, h, dh = _mlstm_dims(cfg)
    up = tp_gathered(tp_linear(p["w_up"], x, ms, d, 2 * pf), ms, 2 * pf)
    xm, z = torch.chunk(up, 2, dim=-1)
    conv_state = state["conv"] if state else None
    xc, conv_state = causal_conv1d(xm, p["conv"]["kernel"], conv_state)
    xc = F.silu(xc.to(torch.float32)).to(x.dtype)
    q = _heads(linear(p["w_q"], xc), h).to(torch.float32) / math.sqrt(dh)
    k = _heads(linear(p["w_k"], xc), h).to(torch.float32)
    v = _heads(linear(p["w_v"], xm), h).to(torch.float32)
    gates = linear(p["w_if"], xc).to(torch.float32)  # (B,S,2H)
    ig, fg = torch.chunk(gates, 2, dim=-1)
    lf = _log_sigmoid(fg)
    if state is None:
        cell = mlstm_state_init(cfg, b, device=x.device)
    else:
        cell = {k2: state[k2] for k2 in ("C", "n", "m")}
    if s == 1 and state is not None:  # decode
        y, cell = _mlstm_decode_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], lf[:, 0], cell)
        y = y[:, None]
    else:
        y, cell = _mlstm_chunk_scan(q, k, v, ig, lf, cell, chunk)
    y = _groupnorm_heads(y).reshape(b, s, pf).to(x.dtype) * p["gn_scale"]
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    out = tp_linear(p["w_down"], y, ms, pf, d)
    return out, {"C": cell["C"], "n": cell["n"], "m": cell["m"], "conv": conv_state}


def mlstm_state_init(cfg, batch: int, *, lead: tuple = (), device: Any = None) -> Dict:
    _, h, dh = _mlstm_dims(cfg)
    return {
        "C": torch.zeros((*lead, batch, h, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((*lead, batch, h, dh), dtype=torch.float32, device=device),
        "m": torch.zeros((*lead, batch, h), dtype=torch.float32, device=device),
    }


def mlstm_full_state_init(cfg, batch: int, *, lead: tuple = (), device: Any = None) -> Dict:
    st = mlstm_state_init(cfg, batch, lead=lead, device=device)
    pf, _, _ = _mlstm_dims(cfg)
    st["conv"] = torch.zeros((*lead, batch, CONV_K - 1, pf), dtype=dtype_of(cfg), device=device)
    return st


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, true recurrence) — sequential
# ---------------------------------------------------------------------------


def _slstm_ffd(d: int) -> int:
    return ((4 * d // 3) + 63) // 64 * 64


def slstm_block_init(gen, cfg, dtype, *, lead: tuple = (), device: Any) -> Params:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    ffd = _slstm_ffd(d)
    return {
        "w_in": linear_init(gen, d, 4 * d, dtype, lead=lead, device=device),  # z,i,f,o input projections
        # a raw array, not a linear: the serving form leaves it float
        "r": (_randn(gen, (*lead, 4, h, dh, dh), device) * (1.0 / math.sqrt(dh))).to(dtype),
        "gn_scale": torch.ones((*lead, d), dtype=dtype, device=device),
        "w_up": linear_init(gen, d, 2 * ffd, dtype, lead=lead, device=device),  # GeGLU post-up FFN
        "w_down": linear_init(gen, ffd, d, dtype, lead=lead, device=device),
    }


def _slstm_cell(r: torch.Tensor, xz, xi, xf, xo, state):
    """One timestep.  r: (4,H,dh,dh) float32; x*: (B,H,dh) pre-activations
    from the input projection."""
    c, n, hprev, m = state  # each (B,H,dh)
    rz, ri, rf, ro = r[0], r[1], r[2], r[3]
    z = torch.tanh(xz + torch.einsum("bhd,hde->bhe", hprev, rz))
    it = xi + torch.einsum("bhd,hde->bhe", hprev, ri)
    ft = xf + torch.einsum("bhd,hde->bhe", hprev, rf)
    ot = torch.sigmoid(xo + torch.einsum("bhd,hde->bhe", hprev, ro))
    lf = _log_sigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    i_w = torch.exp(it - m_new)
    f_w = torch.exp(lf + m - m_new)
    c_new = f_w * c + i_w * z
    n_new = torch.maximum(f_w * n + i_w, torch.exp(-m_new))
    h_new = ot * c_new / n_new
    return (c_new, n_new, h_new, m_new), h_new


def slstm_block_apply(p: Params, x: torch.Tensor, cfg, state: Optional[Dict] = None, ms=None):
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    pre = linear(p["w_in"], x).to(torch.float32)  # (B,S,4d)
    pre = pre.reshape(b, s, 4, h, dh)
    st = slstm_state_init(cfg, b, device=x.device) if state is None else state
    cell = (st["c"], st["n"], st["h"], st["m"])
    r = p["r"].to(torch.float32)  # JAX promotes the bfloat16 r against float32 h exactly
    hs = []
    for t in range(s):
        cell, h_t = _slstm_cell(r, pre[:, t, 0], pre[:, t, 1], pre[:, t, 2], pre[:, t, 3], cell)
        hs.append(h_t)
    hs = torch.stack(hs, dim=1)  # (B,S,H,dh)
    hs = _groupnorm_heads(hs).reshape(b, s, d).to(x.dtype) * p["gn_scale"]
    # post-up GeGLU FFN
    ffd = _slstm_ffd(d)
    up = tp_gathered(tp_linear(p["w_up"], hs, ms, d, 2 * ffd), ms, 2 * ffd)
    g, u = torch.chunk(up, 2, dim=-1)
    y = tp_linear(p["w_down"], _gelu(g.to(torch.float32)).to(x.dtype) * u, ms, ffd, d)
    c, n, hh, m = cell
    return y, {"c": c, "n": n, "h": hh, "m": m}


def slstm_state_init(cfg, batch: int, *, lead: tuple = (), device: Any = None) -> Dict:
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    z = torch.zeros((*lead, batch, h, dh), dtype=torch.float32, device=device)
    return {"c": z, "n": z + 1.0, "h": z.clone(), "m": z.clone()}
