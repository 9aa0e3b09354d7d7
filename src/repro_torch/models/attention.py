"""Attention of the PyTorch port: GQA full/causal, flash-style chunked
(online softmax), windowed local, and single-token decode; the port's copy of
the JAX package's ``models/attention.py``.

The float paths are the JAX package's ``einsum`` and ``softmax`` ops, in its
order (``F.scaled_dot_product_attention`` would add in another order, and it
is a library kernel).  Long sequences never materialize O(S²) scores:
:func:`chunked_attention` walks KV chunks carrying (max, denom, acc), and with
``triangular=True`` its causal schedule visits only chunks j ≤ i.

:func:`decode_attention_int8` scores an int8 query against the int8 KV cache
with the port's row-dot kernel (``api.attention_qk``): the one contraction of
the serving path that JAX computes as an int8 ``einsum`` outside Pallas and
PyTorch cannot compute on CUDA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import api
from repro_torch.kernels.api import PrecisionSpec

NEG_INF = -1e30


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


def _gqa_fold(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,Hq,d) -> (B,S,Hkv,G,d)."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _direct_attention(q, k, v, mask) -> torch.Tensor:
    """q: (B,S,Hkv,G,d); k,v: (B,T,Hkv,d); mask: (S,T) bool or None."""
    d = q.shape[-1]
    scores = torch.einsum("bshgd,bthd->bhgst", q, k).to(torch.float32)
    scores = scores / math.sqrt(d)
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgst,bthd->bshgd", probs, v)


def _chunk_update(carry, qc, kc, vc, mask):
    """Online-softmax update for one (q-chunk, kv-chunk) pair.

    carry = (m, l, acc): running max (B,H,G,Sq), denom, accumulator.
    """
    m, l, acc = carry
    d = qc.shape[-1]
    s = torch.einsum("bshgd,bthd->bhgst", qc, kc).to(torch.float32) / math.sqrt(d)
    if mask is not None:
        s = torch.where(mask[None, None, None], s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    pv = torch.einsum("bhgst,bthd->bshgd", p.to(qc.dtype), vc).to(torch.float32)
    acc_new = acc * torch.movedim(corr, -1, 1)[..., None] + pv
    return m_new, l_new, acc_new


def _pair_mask(i: int, j: int, chunk: int, causal: bool, window: int, device=None):
    """Static (chunk, chunk) mask for q-chunk i vs kv-chunk j, or None if the
    pair is fully allowed.  window > 0 limits lookback to ``window`` tokens."""
    idx = torch.arange(chunk, device=device)
    qpos = i * chunk + idx[:, None]
    kpos = j * chunk + idx[None, :]
    # j == i needs the diagonal mask; j > i (only visited by the masked-full
    # baseline schedule) is fully in the future and the same mask zeroes it
    need_causal = causal and j >= i
    # farthest lookback in this pair: (i - j) * chunk + (chunk - 1)
    need_window = window > 0 and (i - j + 1) * chunk - 1 > window
    if not need_causal and not need_window:
        return None
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=device)
    if need_causal:
        mask &= qpos >= kpos
    if need_window:
        mask &= (qpos - kpos) <= window
    return mask


def _pad_seq(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad axis 1."""
    parts = []
    if before:
        parts.append(x.new_zeros((x.shape[0], before, *x.shape[2:])))
    parts.append(x)
    if after:
        parts.append(x.new_zeros((x.shape[0], after, *x.shape[2:])))
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


def chunked_attention(q, k, v, *, causal: bool, chunk: int, triangular: bool, window: int = 0) -> torch.Tensor:
    """Flash-style (banded) attention.  q: (B,S,Hkv,G,d); k,v: (B,T,Hkv,d).

    Loops over q-chunks and, inside, over kv-chunks in the JAX package's
    order (its ``lax.scan`` over the unmasked interior chunks, then the masked
    ones).  ``triangular`` skips j > i chunks for causal attention; ``window``
    > 0 also skips chunks fully outside the local-attention band.
    """
    b, s, hkv, g, d = q.shape
    t = k.shape[1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    t_pad = (-t) % chunk
    if t_pad:  # KV not chunk-aligned: pad and mask the tail keys out of the last chunk
        k, v = _pad_seq(k, 0, t_pad), _pad_seq(v, 0, t_pad)
    nq, nk = s // chunk, (t + t_pad) // chunk
    k_chunks = k.reshape(b, nk, chunk, hkv, d)
    v_chunks = v.reshape(b, nk, chunk, hkv, d)
    dev = q.device

    def pair_mask(i, j):
        m = _pair_mask(i, j, chunk, causal, window, dev)
        if t_pad and j == nk - 1:
            colm = ((j * chunk + torch.arange(chunk, device=dev))[None, :] < t).expand(chunk, chunk)
            m = colm if m is None else (m & colm)
        return m

    outs = []
    for i in range(nq):
        qc = q[:, i * chunk:(i + 1) * chunk]
        carry = (torch.full((b, hkv, g, chunk), NEG_INF, dtype=torch.float32, device=dev),
                 torch.zeros((b, hkv, g, chunk), dtype=torch.float32, device=dev),
                 torch.zeros((b, chunk, hkv, g, d), dtype=torch.float32, device=dev))
        hi = (i + 1) if (causal and triangular) else nk
        lo = max(0, i - (window + chunk - 1) // chunk) if window > 0 else 0
        if causal and triangular:
            masks = {j: pair_mask(i, j) for j in range(lo, hi)}
            plain_js = [j for j in range(lo, hi) if masks[j] is None]
            order = ([(j, None) for j in range(plain_js[0], plain_js[-1] + 1)] if plain_js else []) + \
                [(j, masks[j]) for j in range(lo, hi) if masks[j] is not None]
        else:
            # masked-full baseline: every kv chunk in [lo, hi) visited,
            # causality/banding purely by masks (extra FLOPs issued)
            order = [(j, pair_mask(i, j)) for j in range(lo, hi)]
        for j, mask in order:
            carry = _chunk_update(carry, qc, k_chunks[:, j], v_chunks[:, j], mask)
        _, l, acc = carry
        out = acc / torch.movedim(l, -1, 1)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def full_attention(q, k, v, *, causal: bool, chunk: int, triangular: bool, flash_threshold: int,
                   window: int = 0) -> torch.Tensor:
    """Entry point.  q: (B,S,Hq,d) -> (B,S,Hq,d); k,v: (B,T,Hkv,d)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qf = _gqa_fold(q, hkv)
    if s <= flash_threshold and k.shape[1] <= flash_threshold and not window:
        mask = None
        if causal:
            t = k.shape[1]
            mask = (torch.arange(s, device=q.device)[:, None] + (t - s)) >= torch.arange(t, device=q.device)[None, :]
        out = _direct_attention(qf, k, v, mask)
    else:
        out = chunked_attention(qf, k, v, causal=causal, chunk=min(chunk, s), triangular=triangular,
                                window=window)
    return out.reshape(b, s, hq, d)


def local_attention(q, k, v, window: int) -> torch.Tensor:
    """Causal windowed attention: each query sees the previous ``window``
    tokens.  q: (B,S,Hq,d), k/v: (B,S,Hkv,d).  Chunked attention over
    (previous, self) chunks with chunk == window: O(S·W).
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    w = min(window, s)
    pad = (-s) % w
    q, k, v = (_pad_seq(a, 0, pad) for a in (q, k, v))
    sp = s + pad
    n = sp // w
    dev = q.device
    qf = _gqa_fold(q, hkv).reshape(b, n, w, hkv, hq // hkv, d)
    kc = k.reshape(b, n, w, hkv, d)
    vc = v.reshape(b, n, w, hkv, d)
    # keys: previous chunk ++ self chunk
    kprev = _pad_seq(kc, 1, 0)[:, :-1]
    vprev = _pad_seq(vc, 1, 0)[:, :-1]
    kk = torch.cat([kprev, kc], dim=2)  # (b,n,2w,hkv,d)
    vv = torch.cat([vprev, vc], dim=2)
    qpos = torch.arange(w, device=dev)[:, None] + w  # position within the 2w frame
    kpos = torch.arange(2 * w, device=dev)[None, :]
    mask = (qpos >= kpos) & (qpos - kpos < w + 1)  # (w, 2w)
    # chunk 0 has no real previous chunk: its first-w frame is zero padding
    is_first = (torch.arange(n, device=dev) == 0)[:, None, None]
    mask = mask[None] & ~(is_first & (kpos < w)[None])  # (n, w, 2w)
    scores = torch.einsum("bnshgd,bnthd->bnhgst", qf, kk).to(torch.float32) / math.sqrt(d)
    scores = torch.where(mask[None, :, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bnhgst,bnthd->bnshgd", probs, vv)
    return out.reshape(b, sp, hq, d)[:, :s]


def _kv_qmax(spec: PrecisionSpec) -> int:
    """The int8 cache stores 8-bit payloads; narrower specs use fewer of
    those bits (adaptive precision), wider ones would silently saturate."""
    if spec.act_bits > 8:
        raise ValueError(f"int8 KV cache holds at most 8-bit payloads, got act_bits={spec.act_bits}")
    return 2 ** (spec.act_bits - 1) - 1


def _quantize_rows(xf: torch.Tensor, qmax: int):
    """Symmetric int8 quantization of float32 ``xf`` along its last axis:
    (payload, scale without the last axis).  Both divisions are tensor by
    tensor, as ``api.absmax_scale`` explains: CUDA would turn a division by a
    Python number into a multiply by its reciprocal, one ulp off the CPU."""
    s = api.absmax_scale(xf, -1, qmax)
    xq = torch.clamp(torch.round(xf / s), -qmax, qmax).to(torch.int8)
    return xq, s[..., 0]


def quantize_kv(x: torch.Tensor, spec: PrecisionSpec = PrecisionSpec.int8):
    """Per-(b, t, h) symmetric integer quantization of a (B,T,H,d) tensor —
    PIMSAB adaptive precision on decode state (``spec.act_bits`` wide)."""
    return _quantize_rows(x.to(torch.float32), _kv_qmax(spec))


# int8_scores: the most int32 output bytes one of its row-dot calls may
# write (a call over R batch rows writes R²·Hkv²·G·T·4).  On an H100 such a
# call writes 0.3–0.6 TB/s and an eager call costs about 55 µs of host time,
# so past about 32 MB two calls are faster than one
# (scripts/torch_int8_scores_forms.py)
INT8_SCORES_CALL_BYTES = 1 << 25


def int8_scores_rows_per_call(b: int, hkv: int, g: int, t: int) -> int:
    """Batch rows each row-dot call of :func:`int8_scores` takes: the most
    whose call writes at most INT8_SCORES_CALL_BYTES (at least one row),
    spread evenly over the calls that B then needs."""
    row = hkv * hkv * g * t * 4
    rows = max(1, min(b, math.isqrt(INT8_SCORES_CALL_BYTES // max(row, 1))))
    calls = -(-b // rows)
    return -(-b // calls)


def int8_scores(qq: torch.Tensor, k_q: torch.Tensor) -> torch.Tensor:
    """``einsum("bhgd,bthd->bhgt")`` of int8 ``qq`` (B,Hkv,G,d) and the int8
    cache ``k_q`` (B,T,Hkv,d) → int32, on ``api.attention_qk``.

    Each call takes R consecutive batch rows (:func:`int8_scores_rows_per_call`)
    and scores each of their query rows against each of their cache rows —
    the cache slab read in place as ``(R·T·Hkv, d)``, with no copy — and the
    (b, h) diagonal blocks are taken as views: ⌈B/R⌉ launches a layer
    instead of B·Hkv, at R·Hkv times the products (integers: the scores are
    exact).  R is capped so that the wasted products stay cheaper than the
    launches they save.  The calls run on the operands' device in any
    backend scope (``on_device``): JAX computes this contraction outside the
    kernel registry."""
    b, hkv, g, _ = qq.shape
    return _int8_scores_rows(qq, k_q, int8_scores_rows_per_call(b, hkv, g, k_q.shape[1]))


def _int8_scores_rows(qq: torch.Tensor, k_q: torch.Tensor, rows: int) -> torch.Tensor:
    """:func:`int8_scores` with ``rows`` batch rows a call."""
    b, hkv, g, d = qq.shape
    t = k_q.shape[1]
    parts = []
    with api.on_device():
        for lo in range(0, b, rows):
            r = min(rows, b - lo)
            full = api.attention_qk(qq[lo:lo + r].reshape(r * hkv * g, d), k_q[lo:lo + r].reshape(r * t * hkv, d))
            # (r, hkv, g, r, t, hkv) → its (b, b) then (h, h) diagonals → (r, hkv, g, t)
            diag = full.view(r, hkv, g, r, t, hkv).diagonal(0, 0, 3).diagonal(0, 0, 3)
            parts.append(diag.permute(2, 3, 0, 1))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _valid_mask(scores: torch.Tensor, valid_len: Optional[torch.Tensor]) -> torch.Tensor:
    if valid_len is None:
        return scores
    t = scores.shape[-1]
    keep = torch.arange(t, device=scores.device)[None, None, None] < valid_len[:, None, None, None]
    return torch.where(keep, scores, NEG_INF)


def decode_attention_int8(q1, k_q, v_q, k_s, v_s, valid_len=None,
                          spec: PrecisionSpec = PrecisionSpec.int8) -> torch.Tensor:
    """Integer decode attention (PIMSAB bit-serial attention): the scores run
    int8 × int8 → int32 on the row-dot kernel (:func:`int8_scores`), the
    scales are applied afterwards, and the readout folds the v-scales into
    the probabilities.

    q1: (B,1,Hq,d) float; k_q/v_q: (B,T,Hkv,d) int8; k_s/v_s: (B,T,Hkv) f32.
    """
    qmax = _kv_qmax(spec)
    b, _, hq, d = q1.shape
    hkv = k_q.shape[2]
    qf = _gqa_fold(q1, hkv)[:, 0].to(torch.float32)  # (B,Hkv,G,d)
    qq, qs = _quantize_rows(qf, qmax)  # qs: (B,Hkv,G)
    iscores = int8_scores(qq, k_q)
    scores = iscores.to(torch.float32) * qs[..., None] * torch.movedim(k_s, 1, -1)[:, :, None]
    scores = _valid_mask(scores / math.sqrt(d), valid_len)
    probs = torch.softmax(scores, dim=-1)
    pw = probs * torch.movedim(v_s, 1, -1)[:, :, None]  # (B,Hkv,G,T)
    out = torch.einsum("bhgt,bthd->bhgd", pw, v_q.to(torch.float32))
    return out.reshape(b, 1, hq, d).to(q1.dtype)


def decode_attention(q1, k_cache, v_cache, valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode: q1 (B,1,Hq,d) vs cache (B,T,Hkv,d)."""
    b, _, hq, d = q1.shape
    hkv = k_cache.shape[2]
    qf = _gqa_fold(q1, hkv)[:, 0]  # (B,Hkv,G,d)
    scores = torch.einsum("bhgd,bthd->bhgt", qf, k_cache).to(torch.float32)
    scores = _valid_mask(scores / math.sqrt(d), valid_len)
    probs = torch.softmax(scores, dim=-1).to(q1.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", probs, v_cache)
    return out.reshape(b, 1, hq, d)
