"""Plain PyTorch oracles for the ported kernels (the port's copy of the
matching functions in the JAX package's ``kernels/ref.py``).

Integer semantics are kept exactly: integer inputs accumulate in int32 and
wrap mod 2**32, integer pool means floor-divide.  Two PyTorch habits differ
from JAX's and are handled here: ``torch.sum`` of int32 returns int64 (so the
sums pass ``dtype=torch.int32``), and ``F.unfold`` refuses integer tensors
(so the patch matrices are built with ``Tensor.unfold``).  An int32 matrix
product wraps on the CPU; PyTorch has none on CUDA, so the oracles run on
CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The accumulation type of a kernel input: int32 for integers
    (wrapping), float32 otherwise."""
    return torch.float32 if x.dtype.is_floating_point else torch.int32


I32_MIN, I32_MAX = -(2**31), 2**31 - 1


# ---------------------------------------------------------------------------
# bit-slice decomposition
# ---------------------------------------------------------------------------


def slice_range(bits: int, slice_bits: int = 8) -> Tuple[int, int]:
    """Exactly representable range of the balanced signed-digit
    decomposition: every digit lies in [-2^(sb-1), 2^(sb-1)-1]."""
    n = -(-bits // slice_bits)
    w = sum(1 << (slice_bits * s) for s in range(n))
    half = 1 << (slice_bits - 1)
    return -half * w, (half - 1) * w


def to_slices(x: torch.Tensor, bits: int, slice_bits: int = 8) -> torch.Tensor:
    """Balanced signed-digit radix-2^slice_bits decomposition, low to high.

    Returns ``(n_slices, *x.shape)`` int8 with every digit in
    [-2^(sb-1), 2^(sb-1)-1], so that ``x == Σ_s slices[s] · 2^(sb·s)``
    within :func:`slice_range`; values outside it are clamped.  A range that
    leaves int32 raises ``OverflowError``, as the JAX package's clip does.
    """
    n = -(-bits // slice_bits)
    lo, hi = slice_range(bits, slice_bits)
    if lo < I32_MIN or hi > I32_MAX:
        raise OverflowError(
            f"slice_range({bits}, {slice_bits}) = {(lo, hi)} does not fit int32")
    rem = torch.clamp(x.to(torch.int32), lo, hi)
    half = 1 << (slice_bits - 1)
    mask = (1 << slice_bits) - 1
    out = []
    for s in range(n):
        if s == n - 1:
            digit = rem  # in [-half, half-1] by construction of slice_range
        else:
            digit = torch.bitwise_and(rem + half, mask) - half
            rem = (rem - digit) >> slice_bits  # arithmetic shift
        out.append(digit)
    return torch.stack([d.to(torch.int8) for d in out])


def from_slices(slices: torch.Tensor, slice_bits: int = 8) -> torch.Tensor:
    """The int32 value ``Σ_s slices[s] << (slice_bits·s)`` (wrapping)."""
    acc = torch.zeros(slices.shape[1:], dtype=torch.int32, device=slices.device)
    for s in range(slices.shape[0]):
        acc = acc + (slices[s].to(torch.int32) << (slice_bits * s))
    return acc


def bitslice_pairs_ref(x_slices: torch.Tensor, w_slices: torch.Tensor, slice_bits: int,
                       pairs) -> torch.Tensor:
    """``Σ_{(s,t) in pairs} (x_s @ w_t) << (slice_bits·(s+t))`` of
    (Sx, M, K) int8 × (Sw, K, N) int8 stacks → (M, N) int32, wrapping.  A
    shift of 32 or more gives 0, as in the JAX package."""
    acc = torch.zeros((x_slices.shape[1], w_slices.shape[2]), dtype=torch.int32,
                      device=x_slices.device)
    for s, t in pairs:
        # int8 @ int8 stays int8 in PyTorch, and an int32 product runs without
        # BLAS: multiply in float64, exact while K · 2**14 < 2**53, then wrap
        # through int64 to int32
        prod = (x_slices[s].to(torch.float64) @ w_slices[t].to(torch.float64)).to(torch.int64).to(torch.int32)
        acc = acc + (prod << (slice_bits * (s + t)))
    return acc


def bitslice_matmul_ref(
    x_slices: torch.Tensor, w_slices: torch.Tensor, slice_bits: int = 8
) -> torch.Tensor:
    """(Sx, M, K) int8 × (Sw, K, N) int8 → (M, N) int32 over every slice
    pair: ``Σ_{s,t} (x_s @ w_t) << (slice_bits·(s+t))``."""
    sx, _, k = x_slices.shape
    sw, k2, _ = w_slices.shape
    assert k == k2, (k, k2)
    return bitslice_pairs_ref(x_slices, w_slices, slice_bits,
                              [(s, t) for s in range(sx) for t in range(sw)])


def int_matmul_wide_ref(x: torch.Tensor, w: torch.Tensor, x_bits: int, w_bits: int) -> torch.Tensor:
    """Direct wide-integer oracle: (M, K) × (K, N) in int32 (wrapping)."""
    del x_bits, w_bits
    return x.to(torch.int32) @ w.to(torch.int32)


# ---------------------------------------------------------------------------
# elementwise maps
# ---------------------------------------------------------------------------


def ewise_add_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y.to(x.dtype)


def relu_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# 2-D convolution / pooling
# ---------------------------------------------------------------------------


def conv2d_out_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: int) -> Tuple[int, int]:
    """Output spatial extent of a conv/pool window sweep."""
    return (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """(N, C, H, W) → (N·OH·OW, C·KH·KW) patch matrix (zero-padded borders).

    Column order is (c, kh, kw) row-major — the order a (OC, C, KH, KW)
    weight flattens to, so ``im2col(x) @ w.reshape(OC, -1).T`` is the conv.
    """
    n, c, h, w = x.shape
    oh, ow = conv2d_out_hw(h, w, kh, kw, stride, padding)
    xp = F.pad(x, (padding, padding, padding, padding))
    # (N, C, OH, OW, KH, KW) → (n, oh, ow, c, kh, kw)
    p = xp.unfold(2, kh, stride).unfold(3, kw, stride)
    return p.permute(0, 2, 3, 1, 4, 5).reshape(n * oh * ow, c * kh * kw)


def pool_patches(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """(N, C, H, W) → (N·C·OH·OW, window²) window matrix (no padding).

    Row r holds the window of output element r in row-major (n, c, oh, ow)
    order.
    """
    n, c, h, w = x.shape
    oh, ow = conv2d_out_hw(h, w, window, window, stride, 0)
    p = x.unfold(2, window, stride).unfold(3, window, stride)
    return p.reshape(n * c * oh * ow, window * window)


def _pool_mean(s: torch.Tensor, count: int) -> torch.Tensor:
    """Window mean: integer sums floor-divide (an arithmetic right shift for
    power-of-two counts), float sums take the true mean."""
    if s.dtype.is_floating_point:
        return s / count
    return torch.div(s, count, rounding_mode="floor")


def conv2d_ref(
    x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding: int = 0,
    x_bits: Optional[int] = None, w_bits: Optional[int] = None,
) -> torch.Tensor:
    """(N, C, H, W) × (OC, C, KH, KW) → (N, OC, OH, OW); integer inputs
    accumulate in int32 (wrapping), float inputs in float32.  ``x_bits`` /
    ``w_bits`` are precision hints of the simulator lowering and do not
    change the math."""
    del x_bits, w_bits
    acc = acc_dtype(x)
    n, c, h, hw = x.shape
    oc, _, kh, kw = w.shape
    oh, ow = conv2d_out_hw(h, hw, kh, kw, stride, padding)
    patches = im2col(x.to(acc), kh, kw, stride, padding)
    out = patches @ w.to(acc).reshape(oc, c * kh * kw).T
    return out.reshape(n, oh, ow, oc).permute(0, 3, 1, 2)


def int_matmul_ref(
    x: torch.Tensor, w: torch.Tensor, *,
    x_bits: Optional[int] = None, w_bits: Optional[int] = None,
) -> torch.Tensor:
    """(M, K) × (K, N) integer matmul with int32 accumulation (wrapping)."""
    del x_bits, w_bits
    return x.to(torch.int32) @ w.to(torch.int32)


def maxpool2d_ref(x: torch.Tensor, *, window: int = 2, stride: Optional[int] = None) -> torch.Tensor:
    """(N, C, H, W) → (N, C, OH, OW) window max (no padding)."""
    s = stride or window
    n, c, h, w = x.shape
    oh, ow = conv2d_out_hw(h, w, window, window, s, 0)
    return torch.amax(pool_patches(x, window, s), dim=1).reshape(n, c, oh, ow)


def avgpool2d_ref(x: torch.Tensor, *, window: int = 2) -> torch.Tensor:
    """(N, C, H, W) → (N, C, OH, OW) window average, stride == window.
    Integer inputs floor-divide by the window count."""
    n, c, h, w = x.shape
    oh, ow = conv2d_out_hw(h, w, window, window, window, 0)
    acc = acc_dtype(x)
    s = torch.sum(pool_patches(x, window, window).to(acc), dim=1, dtype=acc)
    return _pool_mean(s, window * window).reshape(n, c, oh, ow)


def global_avgpool_ref(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → (N, C) spatial average (integer: floor-divide by H·W)."""
    n, c, h, w = x.shape
    acc = acc_dtype(x)
    s = torch.sum(x.reshape(n, c, h * w).to(acc), dim=-1, dtype=acc)
    return _pool_mean(s, h * w)


# ---------------------------------------------------------------------------
# transformer decode (attention + KV cache).  All-integer and bit-exact: every
# ``>>`` is arithmetic (floor), int32 arithmetic wraps.
# ---------------------------------------------------------------------------

# The fixed-point softmax constants of the JAX package's oracles.
SOFTMAX_F = 6    # fraction bits of exponentials and output probabilities
SOFTMAX_K = 3    # range-reduction squarings: exp(t) ≈ (quad(t/2^K))^(2^K)
SOFTMAX_FI = 8   # extra fraction bits of the row-sum reciprocal


def attention_qk_ref(
    q: torch.Tensor, k: torch.Tensor, *,
    q_bits: Optional[int] = None, k_bits: Optional[int] = None,
    out_bits: Optional[int] = None,
) -> torch.Tensor:
    """(M, D) query block × (T, D) key cache → (M, T) int32 scores q·Kᵀ
    (wrapping).  ``q_bits``/``k_bits``/``out_bits`` are precision hints of
    the simulator lowering (``out_bits``: the caller's promise that every
    score fits that many signed bits) and do not change the math."""
    del q_bits, k_bits, out_bits
    return q.to(torch.int32) @ k.to(torch.int32).T


def softmax_sigma(in_frac: int) -> int:
    """The range-reduction shift σ = in_frac − F + K of the fixed-point
    softmax; raises where the JAX package does: ``NotImplementedError``
    below ``in_frac`` = F − K (the shift cannot go left), ``OverflowError``
    where the clamp bound −2^(F+σ) leaves int32."""
    f, kk = SOFTMAX_F, SOFTMAX_K
    in_frac = int(in_frac)
    if in_frac < f - kk:
        raise NotImplementedError(
            f"softmax_fixedpoint needs in_frac >= {f - kk} (got {in_frac})"
        )
    sigma = in_frac - f + kk
    if f + sigma > 31:
        raise OverflowError(
            f"softmax_fixedpoint: in_frac={in_frac} puts the clamp bound "
            f"-2^{f + sigma} outside int32"
        )
    return sigma


def softmax_fixedpoint_ref(
    x: torch.Tensor, *, in_frac: int, in_bits: Optional[int] = None
) -> torch.Tensor:
    """Bit-exact fixed-point row softmax over the last axis of (R, T) ints.

    Inputs carry ``in_frac`` fraction bits; outputs are int32 probabilities
    with ``SOFTMAX_F`` fraction bits (rows sum to ≈ ``2**SOFTMAX_F``).  Every
    ``>>`` is arithmetic (floor), the arithmetic int32:

        t   = x - rowmax(x)
        tcl = max(t, -2^(F+σ));  u = tcl >> σ          σ = in_frac - F + K
        w   = u + 2^F + (u² >> (F+1))         # quadratic seed of exp(u/2^F)
        w   = (w² >> F)  (K times)            # undo the 2^K range reduction
        q   = 2^(FI+F) // Σ_t w               # exact floor division
        p   = (w · q) >> FI

    ``in_bits`` is a width hint of the simulator lowering.  Reads no values,
    so it runs on ``meta`` tensors.
    """
    del in_bits
    f, kk, fi = SOFTMAX_F, SOFTMAX_K, SOFTMAX_FI
    sigma = softmax_sigma(in_frac)
    xi = x.to(torch.int32)
    t = xi - torch.amax(xi, dim=-1, keepdim=True)
    tcl = torch.clamp_min(t, -(1 << (f + sigma)))
    u = tcl >> sigma
    w = u + (1 << f) + ((u * u) >> (f + 1))
    for _ in range(kk):
        w = (w * w) >> f
    s = torch.sum(w, dim=-1, keepdim=True, dtype=torch.int32)
    q = torch.div(torch.full_like(s, 1 << (fi + f)), s, rounding_mode="floor")
    return (w * q) >> fi


def attention_pv_ref(
    p: torch.Tensor, v: torch.Tensor, *, shift: int = SOFTMAX_F,
    p_bits: Optional[int] = None, v_bits: Optional[int] = None,
) -> torch.Tensor:
    """(M, T) probabilities × (T, Dv) value cache → (M, Dv) int32: the int32
    accumulator (wrapping) arithmetically shifted right by ``shift`` (a shift
    of 32 or more, or a negative one, fills with the sign, as in JAX)."""
    del p_bits, v_bits
    return (p.to(torch.int32) @ v.to(torch.int32)) >> int(shift)


def kv_append_ref(
    cache: torch.Tensor, new: torch.Tensor, onehot: torch.Tensor
) -> torch.Tensor:
    """(T, D) cache with every row whose selector entry in the (T,)
    ``onehot`` is nonzero replaced by the (D,) ``new`` row cast to the
    cache's dtype (an int32 → int8 cast wraps); an all-zero selector is a
    no-op.  Returns a new tensor; the input cache is left as it was."""
    sel = (onehot != 0)[:, None]
    return torch.where(sel, new[None, :].to(cache.dtype), cache)


def decode_gemv_ref(
    w: torch.Tensor, x: torch.Tensor, *,
    w_bits: Optional[int] = None, x_bits: Optional[int] = None,
) -> torch.Tensor:
    """(M, K) weights × (K,) activation → (M,) int32, the single-token decode
    projection (wrapping).  ``w_bits``/``x_bits`` are precision hints of the
    simulator lowering and do not change the math."""
    del w_bits, x_bits
    return w.to(torch.int32) @ x.to(torch.int32)


# ---------------------------------------------------------------------------
# H-tree reduction
# ---------------------------------------------------------------------------


def htree_reduce_ref(x: torch.Tensor) -> torch.Tensor:
    """Pairwise log-depth tree sum over the leading axis (N a power of two):
    adjacent pairs first, then pairs of pairs, each partial sum rounded to
    the input's dtype (int32 wraps)."""
    n = x.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"the H-tree needs a power-of-two count of lanes, got {n}")
    y = x
    while y.shape[0] > 1:
        y = y[0::2] + y[1::2]
    return y[0]


# ---------------------------------------------------------------------------
# RG-LRU linear scan
# ---------------------------------------------------------------------------


def _associative_scan(comb, elems, dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim`` with the
    associative ``comb``, in the order of ``jax.lax.associative_scan``:
    combine adjacent pairs, scan the pair sums recursively, then fill in the
    even positions."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    odd = _associative_scan(comb, comb(tuple(sl(e, 0, -1, 2) for e in elems),
                                       tuple(sl(e, 1, None, 2) for e in elems)), dim)
    rest = tuple(sl(e, 2, None, 2) for e in elems)
    head = tuple(sl(o, 0, -1) for o in odd) if n % 2 == 0 else odd
    even = tuple(torch.cat([sl(e, 0, 1), c], dim) for e, c in zip(elems, comb(head, rest)))
    out = tuple(torch.empty_like(e) for e in elems)
    for o, ev, od in zip(out, even, odd):  # interleave: even positions, then odd
        sl(o, 0, None, 2).copy_(ev)
        sl(o, 1, None, 2).copy_(od)
    return out


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1.  a, b: (B, T, W) fp32; h0: (B, W).

    ``a[:, 0]·h0`` is added into ``b[:, 0]``, then the pairs (a, b) are
    scanned with the combine ``(a1·a2, a2·b1 + b2)`` in the JAX oracle's
    order.  Reads no values, so it runs on ``meta`` tensors."""

    def comb(e1, e2):
        (a1, b1), (a2, b2) = e1, e2
        return a1 * a2, a2 * b1 + b2

    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return _associative_scan(comb, (a, b), 1)[1]
